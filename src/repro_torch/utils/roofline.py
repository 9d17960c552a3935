"""The H100's roofline (port of ``repro/utils/roofline.py``, with the
H100's data-sheet rates in place of the TPU's).

Three terms per traced program, all in seconds:

    compute    = FLOPs            / peak FLOP/s
    memory     = bytes accessed   / HBM bytes/s
    collective = collective bytes / link bytes/s
                 + collectives x ring hops x hop latency

The largest is the roofline's step time and its name the bottleneck. The
counts come from ``utils/cost.full_cost``, which traces one rank's program
(the per-rank work of a data- and tensor-parallel step), so no term
divides by the number of devices; ``chips`` serves the ratio of the model's
useful FLOPs (6·N·D for a train step, 2·N·D forward, over all devices) to
the traced ones.

``kernel_bound_ms`` is the least time one kernel launch could take on the
card, the bound ``chip_smoke.py`` prints beside each kernel's time.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class HardwareSpec:
    """Per-device roofline constants."""

    name: str
    peak_flops: float           # bf16 FLOP/s (dense tensor cores)
    hbm_bw: float               # bytes/s
    link_bw: float              # bytes/s per interconnect link
    hbm_bytes: float            # capacity (the out-of-memory threshold)
    coll_hop_latency: float     # seconds per collective per ring hop
    f32_flops: float = 0.0      # f32 FLOP/s outside the tensor cores


# NVIDIA H100 80 GB SXM, data-sheet rates at its 700 W limit: 989 TFLOP/s
# bf16 and 67 TFLOP/s f32 (dense), 3.35 TB/s HBM3, 450 GB/s NVLink a
# direction; the hop latency is a small-payload NCCL all-reduce's
# (about 10 us a hop across NVLink and InfiniBand at 128 GPUs).
H100 = HardwareSpec("h100-80g", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9, hbm_bytes=80e9, coll_hop_latency=12e-6,
                    f32_flops=67e12)


@dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float            # the traced rank's FLOPs
    hlo_bytes: float            # the traced rank's bytes accessed
    collective_bytes: float     # the traced rank's collective bytes
    model_flops: float          # analytic 6*N*D (or 2*N*D), all devices
    collective_count: float = 0.0   # collectives issued
    ring_size: int = 1              # hops per collective (latency model)
    hw: "HardwareSpec" = None
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_flops_ratio: float = 0.0
    peak_memory_bytes: float = 0.0

    def finalize(self) -> "RooflineReport":
        hw = self.hw or H100
        self.compute_s = self.hlo_flops / hw.peak_flops
        self.memory_s = self.hlo_bytes / hw.hbm_bw
        # bandwidth term + per-op latency floor (rings serialize hops)
        self.collective_s = (self.collective_bytes / hw.link_bw
                             + self.collective_count * self.ring_size
                             * hw.coll_hop_latency)
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        per_chip_model_flops = self.model_flops / max(self.chips, 1)
        self.useful_flops_ratio = (
            per_chip_model_flops / self.hlo_flops if self.hlo_flops else 0.0
        )
        return self

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> dict:
        d = asdict(self)
        d["step_time_s"] = self.step_time_s
        return d


def analyze(name, *, chips, cost_analysis, collective_bytes, model_flops,
            peak_memory_bytes=0.0, collective_count=0.0, ring_size=1,
            hw=H100) -> RooflineReport:
    """A ``RooflineReport`` from a traced program's counts.

    cost_analysis: ``{"flops": ..., "bytes accessed": ...}`` (the keys of
    XLA's ``cost_analysis()``, which ``FullCost`` fills).
    collective_bytes: ``FullCost.collective_bytes``.
    model_flops: analytic useful FLOPs (6*N*D for training, 2*N*D forward).
    """
    flops = float(cost_analysis.get("flops", 0.0) or 0.0)
    nbytes = float(cost_analysis.get("bytes accessed", 0.0) or 0.0)
    return RooflineReport(
        name=name,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=nbytes,
        collective_bytes=float(collective_bytes),
        model_flops=float(model_flops),
        collective_count=float(collective_count),
        ring_size=int(ring_size),
        hw=hw,
        peak_memory_bytes=float(peak_memory_bytes),
    ).finalize()


def kernel_bound_ms(nbytes: float, flops: float, *, f32: bool = False,
                    hw: HardwareSpec = H100):
    """``(ms, by)``: the least time one launch could take, the larger of
    its bytes over the HBM rate and its operations over the peak rate of
    its inputs' type (``f32``: outside the tensor cores), and which of
    the two ("bytes" or "operations") bounds it."""
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = flops / (hw.f32_flops if f32 else hw.peak_flops) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def model_flops_train(n_params_active: float, n_tokens: float) -> float:
    """Classic 6*N*D for a full fwd+bwd training step."""
    return 6.0 * n_params_active * n_tokens


def model_flops_forward(n_params_active: float, n_tokens: float) -> float:
    return 2.0 * n_params_active * n_tokens


def format_table(reports, headers=None) -> str:
    """Markdown table of roofline reports."""
    cols = [
        ("pair", lambda r: r.name),
        ("chips", lambda r: str(r.chips)),
        ("compute_s", lambda r: f"{r.compute_s:.4g}"),
        ("memory_s", lambda r: f"{r.memory_s:.4g}"),
        ("coll_s", lambda r: f"{r.collective_s:.4g}"),
        ("bottleneck", lambda r: r.bottleneck),
        ("useful_ratio", lambda r: f"{r.useful_flops_ratio:.3f}"),
        ("peak_mem_GiB", lambda r: f"{r.peak_memory_bytes / 2**30:.2f}"),
    ]
    lines = ["| " + " | ".join(c for c, _ in cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in reports:
        lines.append("| " + " | ".join(f(r) for _, f in cols) + " |")
    return "\n".join(lines)
