"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the smoke-size rollout through them. Every test here needs a
CUDA device and nvcc and skips without one; this file imports no JAX, so
it runs on a GPU machine that has none:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances are set at each case's own output scale s = max|ref|, as in
``chip_smoke.py``: f32 outputs within 32 f32 ulps of s (the same f32 math
in another order, atol 2^-18 s); bf16 outputs add one bf16 ulp of each
element (two nearby f32 results may round to adjacent bf16 values, rtol
2^-7); log-probs within (V/1024 + 60) unit roundings of the two f32
logsumexps plus 8 ulps of the largest |log-prob|. Flash-attention
gradients within 2^-14 s: each is a sum of up to group x S products of
terms that cancel in dS = P(dP - D), summed in another order. The
spec-verify kernel is held against its plain version by the same rule,
and each of its queries j bitwise (0 ulp) against the paged kernel at
lens = pos + j + 1, which runs the same per-row code. The SSD scan
kernel's y and final state at fp32, and its final state at bf16, within
32 f32 ulps of their scale (the same f32 math in another order); its bf16
y within 2^-6 s plus one bf16 ulp of each element: the plain chunked form
rounds W and W x to bf16 before its sums, where the kernel keeps f32
(``chip_smoke.py`` reports both against an f64 evaluation at the
ssm_score shape: on an H100 the plain version was the further from it).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.stages import EarlTrainer, ExpPrepStage
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.kernels.fused_sample import ops as fs_ops
from repro_torch.kernels.fused_sample.ref import NEG_INF, fused_sample_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
from repro_torch.kernels.spec_verify import ops as sv_ops
from repro_torch.kernels.spec_verify.ref import spec_verify_attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.models.registry import build_model
from repro_torch.rl.engine import CompiledRolloutEngine
from repro_torch.rl.envs import TicTacToe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU, see "
                    "README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


PAGED_CASES = {
    # name: (B, NP, P, ps, H, KV, hd, lens, int8, drop); drop lists
    # (row, first page, end page) runs of the block table left unmapped.
    # At NP=16, ps=16 and B*KV <= 132 the kernel splits a row into 4
    # chunks of 4 pages (64 positions), at NP=64 and B=1 into 8 chunks of
    # 8, at NP=128 into 8 chunks of 16.
    "shuffled_table": (3, 4, 16, 8, 4, 2, 32, [25, 9, 32], False, ()),
    "lens_zero_and_partial_page": (3, 4, 16, 8, 4, 2, 32, [0, 17, 8], False,
                                   ()),
    "qwen2_heads": (4, 16, 65, 16, 14, 2, 64, [256, 1, 100, 0], False, ()),
    "int8_scales": (3, 4, 16, 8, 4, 2, 32, [25, 0, 13], True, ()),
    "big_pages_hd128": (2, 2, 8, 128, 8, 1, 128, [200, 129], False, ()),
    # lens at a chunk boundary and one either side, a lens = 0 row
    "lens_at_chunk_edges": (6, 16, 97, 16, 14, 2, 64,
                            [64, 63, 65, 128, 0, 256], False, ()),
    # a chunk whose pages are all unmapped while the row's others are live
    "chunk_all_unmapped": (4, 16, 65, 16, 14, 2, 64, [256, 200, 100, 70],
                           False, ((0, 4, 8), (1, 12, 16), (3, 4, 5))),
    "b1_most_chunks": (1, 64, 64, 16, 14, 2, 64, [1000], False, ()),
    "np128_s2048": (2, 128, 256, 16, 14, 2, 64, [2048, 1500], False, ()),
    "int8_chunks": (4, 16, 65, 16, 14, 2, 64, [256, 65, 0, 129], True,
                    ((0, 8, 12),)),
}


def _paged_case(seed, B, NP, P, ps, H, KV, hd, lens, int8, drop, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g)
    if int8:
        kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g).to(
            torch.int8)
        vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g).to(
            torch.int8)
        ks = torch.rand((P, ps, KV), generator=g) / 127
        vs = torch.rand((P, ps, KV), generator=g) / 127
    else:
        kp = torch.randn((P, ps, KV, hd), generator=g)
        vp = torch.randn((P, ps, KV, hd), generator=g)
        ks = vs = None
    lens = torch.tensor(lens, dtype=torch.int32)
    perm = torch.randperm(P, generator=g)[:B * NP].reshape(B, NP)
    npages = (lens + ps - 1) // ps
    bt = torch.where(torch.arange(NP)[None, :] < npages[:, None], perm, -1)
    if npages[0] > 1:
        bt[0, 1] = -1                    # unmapped entry inside the range
    for row, first, end in drop:
        bt[row, first:end] = -1
    out = [q, kp, vp, bt.to(torch.int32), lens, ks, vs]
    return [None if t is None else t.to(device) for t in out]


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain_version(name, qdtype, dev):
    q, kp, vp, bt, lens, ks, vs = _paged_case(0, *PAGED_CASES[name], dev)
    q = q.to(qdtype)
    if ks is None:
        kp, vp = kp.to(qdtype), vp.to(qdtype)
    n0 = pa_ops.launches
    out = pa_ops.paged_decode_attention(q, kp, vp, bt, lens, k_scales=ks,
                                        v_scales=vs)
    assert pa_ops.launches == n0 + 1
    ref = paged_decode_attention_ref(q, kp, vp, bt, lens, ks, vs)
    torch.cuda.synchronize()
    atol = 2.0 ** -18 * float(ref.float().abs().max())
    rtol = 0.0 if qdtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    for i in (lens == 0).nonzero().flatten().tolist():
        assert not bool(out[i].any())    # fully masked row outputs zeros


@pytest.mark.parametrize("name", ["np128_s2048", "chunk_all_unmapped"])
def test_paged_attention_is_deterministic(name, dev):
    """Each chunk's partial is merged by one warp in chunk order, with no
    atomics: two launches on the same inputs agree bitwise."""
    q, kp, vp, bt, lens, ks, vs = _paged_case(4, *PAGED_CASES[name], dev)
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    first = pa_ops.paged_decode_attention(q, kp, vp, bt, lens)
    second = pa_ops.paged_decode_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_kernels_refuse_misaligned_pools(dev):
    """Both kernels read pool rows by 16-byte copies: a pool view off a
    16-byte boundary is refused, not read another way."""
    q, kp, vp, bt, lens, _, _ = _paged_case(1, *PAGED_CASES["shuffled_table"],
                                            dev)
    odd = torch.empty(kp.numel() + 1, device=dev)[1:].view(kp.shape)
    odd.copy_(kp)
    with pytest.raises(ValueError, match="16-byte"):
        pa_ops.paged_decode_attention(q, odd, vp, bt, lens)
    with pytest.raises(ValueError, match="16-byte"):
        sv_ops.spec_verify_attention(q[:, None].contiguous(), kp, odd, bt,
                                     lens)


def test_paged_attention_wrapper_checks_inputs(dev):
    q, kp, vp, bt, lens, _, _ = _paged_case(1, *PAGED_CASES["shuffled_table"],
                                            dev)
    with pytest.raises(TypeError, match="int32"):
        pa_ops.paged_decode_attention(q, kp, vp, bt.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_decode_attention(q, kp.transpose(0, 1), vp.transpose(
            0, 1), bt, lens)
    with pytest.raises(ValueError, match="scales"):
        pa_ops.paged_decode_attention(q, kp.to(torch.int8),
                                      vp.to(torch.int8), bt, lens)


DECODE_CASES = {
    # name: (B, S, H, KV, hd, mask)
    "random_fill_group2": (3, 64, 4, 2, 32, "fill"),
    "path_heads_s256": (4, 256, 14, 2, 64, "fill"),
    "ragged_s100_ring_window": (3, 100, 14, 2, 64, "ring"),
    "empty_first_chunks": (2, 257, 8, 1, 128, "late"),
    "fully_masked_row": (3, 96, 4, 2, 64, "none"),
    # the cluster's edges: 8 chunks of several tiles each; the widest
    # head; one pair (B=1, group 1) whose S=200 keys split into 3 chunks
    # of 96 (the last ragged), and whose S=512 keys fill a whole cluster
    # (8 chunks of 64); valid keys starting mid-tile; hd 96 (3 lanes'
    # groups of 8)
    "long_s2048_fill": (2, 2048, 14, 2, 64, "fill"),
    "hd256": (2, 300, 8, 2, 256, "fill"),
    "group1_b1": (1, 200, 1, 1, 64, "fill"),
    "group1_b1_cluster8": (1, 512, 1, 1, 64, "fill"),
    "valid_from_mid_tile": (3, 256, 14, 2, 64, "mid"),
    "hd96_ring": (2, 130, 6, 2, 96, "ring"),
}


def decode_valid(kind, B, S, g):
    """(B,S) bool masks: "fill" a random fill pos in [1,S) (keys <= pos);
    "ring" a wrapped ring buffer of S slots with a window of S//2; "late"
    keys valid only from S-40 on (whole empty leading chunks); "mid" keys
    valid from 45 (inside the second 32-key tile) to a random pos >= 45;
    "none" a random fill with row 0 fully masked."""
    idx = torch.arange(S)[None, :]
    if kind == "mid":
        pos = torch.randint(45, S, (B, 1), generator=g)
        return (idx >= 45) & (idx <= pos)
    if kind == "ring":
        pos = torch.randint(S, 3 * S, (B, 1), generator=g)
        kpos = pos - torch.remainder(pos - idx, S)
        return (kpos >= 0) & (kpos <= pos) & (kpos > pos - S // 2)
    if kind == "late":
        return (idx >= S - 40).expand(B, S).clone()
    pos = torch.randint(1, S, (B, 1), generator=g)
    valid = idx <= pos
    if kind == "none":
        valid[0] = False
    return valid


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("qdtype,kvdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_attention_kernel_matches_plain_version(name, qdtype, kvdtype,
                                                       dev):
    B, S, H, KV, hd, mask = DECODE_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn((B, H, hd), generator=g).to(dev, qdtype)
    # a strided view of a layer-stacked cache, as the model passes it
    k, v = (torch.randn((2, B, S, KV, hd), generator=g).to(dev, kvdtype)[1]
            for _ in range(2))
    valid = decode_valid(mask, B, S, g).to(dev)
    n0 = da_ops.launches
    out = da_ops.decode_attention(q, k, v, valid)
    assert da_ops.launches == n0 + 1
    ref = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    atol = 2.0 ** -18 * float(ref.float().abs().max())
    rtol = 0.0 if qdtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    if mask == "none":                   # the mean of V over S
        mean = v[0].float().mean(0).repeat_interleave(H // KV, 0)
        torch.testing.assert_close(out[0].float(), mean.to(qdtype).float(),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["path_heads_s256", "long_s2048_fill"])
def test_decode_attention_is_deterministic(name, dev):
    """Each chunk's partial is merged by one warp in chunk order, with no
    atomics: two launches on the same inputs agree bitwise."""
    B, S, H, KV, hd, mask = DECODE_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(4)
    q = torch.randn((B, H, hd), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    valid = decode_valid(mask, B, S, g).to(dev)
    first = da_ops.decode_attention(q, k, v, valid)
    second = da_ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
def test_decode_attention_misaligned_cache_takes_element_copies(kvdtype,
                                                                dev):
    """A K/V view one element past a 16-byte boundary cannot be read by
    16-byte copies: the kernel copies its tiles element by element and
    gives the plain version's result all the same."""
    B, S, H, KV, hd, mask = DECODE_CASES["path_heads_s256"]
    g = torch.Generator(device="cpu").manual_seed(5)
    q = torch.randn((B, H, hd), generator=g).to(dev, torch.bfloat16)
    n = B * S * KV * hd
    k, v = (torch.randn((n + 1,), generator=g).to(dev, kvdtype)[1:]
            .view(B, S, KV, hd) for _ in range(2))
    assert k.data_ptr() % 16
    valid = decode_valid(mask, B, S, g).to(dev)
    out = da_ops.decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), ref.float(),
        atol=2.0 ** -18 * float(ref.float().abs().max()), rtol=2.0 ** -7)


def test_decode_attention_wrapper_checks_inputs(dev):
    q = torch.randn((2, 4, 32), device=dev)
    k = torch.randn((2, 16, 2, 32), device=dev)
    valid = torch.ones((2, 16), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="bool"):
        da_ops.decode_attention(q, k, k, valid.int())
    with pytest.raises(TypeError, match="bfloat16"):
        da_ops.decode_attention(q, k.half(), k.half(), valid)
    with pytest.raises(ValueError, match="contiguously"):
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)
        da_ops.decode_attention(q, kt, kt, valid)
    with pytest.raises(ValueError, match="head_dim"):
        da_ops.decode_attention(q[..., :16].contiguous(),
                                k[..., :16].contiguous(),
                                k[..., :16].contiguous(), valid)


def _lp_atol(lp_ref, V):
    return ((V / 1024 + 60) * 2.0 ** -24
            + 8 * 2.0 ** -23 * float(lp_ref.abs().max()))


def _sample_inputs(seed, B, V, noise, device):
    rs = np.random.RandomState(seed)
    lg = (rs.standard_normal((B, V)) * 3).astype(np.float32)
    lg[0, 7] = lg[0, V - 3] = 50.0       # planted tie: the earliest wins
    nz = (np.zeros((B, V), np.float32) if noise == "zero" else
          rs.gumbel(size=(B, V)).astype(np.float32))
    nz[0] = 0.0
    return torch.from_numpy(lg).to(device), torch.from_numpy(nz).to(device)


@pytest.mark.parametrize("V", [1000, 2500, 151936, 151937, 32004])
@pytest.mark.parametrize("noise", ["zero", "gumbel"])
def test_fused_sample_kernel_matches_plain_version(V, noise, dev):
    """V=32004 is a multiple of 4 but not of 4 k (k = 8 blocks a row): the
    last block's slice is shorter; 151937 takes the scalar loads."""
    lg, nz = _sample_inputs(3, 8, V, noise, dev)
    n0 = fs_ops.launches
    tok, lp = fs_ops.fused_sample(lg, nz)
    assert fs_ops.launches == n0 + 1
    tok_r, lp_r = fused_sample_ref(lg, nz)
    assert torch.equal(tok, tok_r) and int(tok[0]) == 7
    torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, V), rtol=0)


def _plan(B, V, dev):
    return fs_ops.cluster_plan(B, V, torch.cuda.get_device_properties(
        dev).multi_processor_count)


@pytest.mark.parametrize("B", [1, 32])
def test_fused_sample_tie_across_cluster_blocks(B, dev):
    """A tie planted in blocks 3 and 5 of the row's cluster, none in block
    0: the merge keeps the earlier index. B=1 runs at the largest k."""
    V = 151936
    k, sl = _plan(B, V, dev)
    assert k == 8
    lg, nz = _sample_inputs(5, B, V, "gumbel", dev)
    i, j = 3 * sl + 17, 5 * sl + 2
    lg[:, i] = lg[:, j] = 60.0
    nz[:, i] = nz[:, j] = 0.0
    tok, lp = fs_ops.fused_sample(lg, nz)
    tok_r, lp_r = fused_sample_ref(lg, nz)
    assert torch.equal(tok, tok_r) and (tok == i).all()
    torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, V), rtol=0)


def test_fused_sample_mostly_masked_rows(dev):
    """Rows that top-p left mostly at NEG_INF: a handful of live logits
    in a row of -1e30, one row with a single live logit."""
    B, V = 4, 151936
    lg, nz = _sample_inputs(6, B, V, "gumbel", dev)
    keep = torch.zeros((B, V), dtype=torch.bool, device=dev)
    keep[:, [5, 40000, 90001, 151935]] = True
    keep[3] = False
    keep[3, 120000] = True
    lg = torch.where(keep, lg, torch.full_like(lg, NEG_INF))
    tok, lp = fs_ops.fused_sample(lg, nz)
    tok_r, lp_r = fused_sample_ref(lg, nz)
    assert torch.equal(tok, tok_r) and int(tok[3]) == 120000
    assert float(lp[3]) == 0.0
    torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, V), rtol=0)


@pytest.mark.parametrize("V", [50280, 151936])
def test_fused_sample_every_cluster_size_gives_the_same_tokens(V, dev):
    """Every k from 1 to 8 blocks a row: tokens bitwise those of ref.py,
    lp within the same tolerance; the plan's own launch is one call."""
    lg, nz = _sample_inputs(7, 8, V, "gumbel", dev)
    tok_r, lp_r = fused_sample_ref(lg, nz)
    for k in range(1, 9):
        sl = 4 * -(-V // (4 * k))
        tok, lp = fs_ops._launch(lg, nz, (-(-V // sl), sl))
        assert torch.equal(tok, tok_r), k
        torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, V), rtol=0)


def test_fused_sample_more_rows_than_a_grid_column_holds(dev):
    """66,000 rows (a grid's y and z dims stop at 65,535) at two blocks a
    row: the rows run along the grid's x, tokens bitwise ref.py's."""
    B, V = 66000, 4096
    assert _plan(B, V, dev)[0] == 2
    g = torch.Generator(device=dev).manual_seed(8)
    lg = torch.randn((B, V), generator=g, device=dev) * 3
    nz = torch.randn((B, V), generator=g, device=dev)
    tok, lp = fs_ops.fused_sample(lg, nz)
    tok_r, lp_r = fused_sample_ref(lg, nz)
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, V), rtol=0)


def test_fused_sample_misaligned_rows_take_scalar_loads(dev):
    """A view starting one float in is still contiguous but not 16-byte
    aligned: the kernel must fall back to scalar loads and agree."""
    lg, nz = _sample_inputs(4, 4, 2048, "gumbel", dev)
    buf = torch.empty(lg.numel() + 1, device=dev)
    flat_l = buf[1:].view(4, 2048)
    flat_l.copy_(lg)
    assert flat_l.is_contiguous() and flat_l.data_ptr() % 16
    tok, lp = fs_ops.fused_sample(flat_l, nz)
    tok_r, lp_r = fused_sample_ref(flat_l, nz)
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(lp, lp_r, atol=_lp_atol(lp_r, 2048), rtol=0)


@pytest.fixture
def smoke(dev):
    model = build_model(get_smoke_config("qwen2-0.5b"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=torch.float32)
    # the defaults: attn_impl="paged", sampling="fused", on the card
    eng = CompiledRolloutEngine(
        model, TicTacToe(), kv_dtype="fp32", temperature=1.0, max_turns=3,
        max_turn_tokens=4, max_context=96)
    return model, params, eng


def test_smoke_rollout_runs_through_both_kernels(smoke):
    model, params, eng = smoke
    pa_ops.reset_launches()
    fs_ops.reset_launches()
    exp, st = eng.run(params, 4, 8,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    assert pa_ops.launches > 0 and fs_ops.launches > 0
    assert pa_ops.launches % model.cfg.n_layers == 0
    assert st.episodes_started == st.episodes_returned == 8
    assert st.kv_dropped_writes == 0
    assert bool(torch.isfinite(exp.logprobs).all())


def test_macro_step_makes_no_host_sync(smoke):
    _, params, eng = smoke
    carry = eng.init_feed(params, eng.init_carry(4, 8))
    noise = eng.default_noise(torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = eng.turn_step(params, carry, 0, noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(carry.launched) >= 4


FLASH_CASES = {
    # name: (B, S, Sk, H, KV, hd, causal, window)
    "s96_group2_hd32": (2, 96, 96, 4, 2, 32, True, 0),
    "update_heads_group7": (2, 256, 256, 14, 2, 64, True, 0),
    "ragged_s100": (1, 100, 100, 14, 2, 64, True, 0),
    "window_after_empty_slab": (1, 200, 200, 4, 2, 32, True, 40),
    "not_causal_hd128": (1, 130, 130, 8, 1, 128, False, 0),
    # the edges of the 64-row tiles and of the TMA boxes
    "ragged_s257": (2, 257, 257, 14, 2, 64, True, 0),
    "ragged_s65": (2, 65, 65, 14, 2, 64, True, 0),
    "s_below_sk_not_causal": (2, 100, 200, 8, 2, 64, False, 0),
    "group1": (2, 192, 192, 4, 4, 64, True, 0),
    "window_ends_mid_tile": (2, 300, 300, 6, 2, 64, True, 100),
    "causal_hd32": (2, 256, 256, 8, 2, 32, True, 0),
    "causal_hd128": (2, 200, 200, 8, 2, 128, True, 0),
    # 12 heads x 3 rows x 16 q tiles = 576 forward blocks, > 4 x 132 SMs
    "more_blocks_than_4_per_sm": (3, 1000, 1000, 12, 4, 64, True, 0),
}


def _flash_inputs(seed, B, S, H, KV, hd, dtype, device, Sk=None):
    Sk = S if Sk is None else Sk
    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = [(B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd), (B, S, H, hd)]
    return [torch.randn(sh, generator=g).to(device=device, dtype=dtype)
            for sh in shapes]


def _held(out, ref, rel, dtype):
    s = float(ref.float().abs().max())
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=rel * s,
                               rtol=rtol)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_versions(name, dtype, dev):
    B, S, Sk, H, KV, hd, causal, window = FLASH_CASES[name]
    q, k, v, do = _flash_inputs(0, B, S, H, KV, hd, dtype, dev, Sk)
    n0 = dict(fa_ops.launches)
    out, L = fa_ops.flash_attention_fwd(q, k, v, causal, window)
    grads = fa_ops.flash_attention_bwd(q, k, v, out, do, L, causal, window)
    assert fa_ops.launches == {key: n + 1 for key, n in n0.items()}
    out_r, L_r = attention_fwd_ref(q, k, v, causal, window)
    # the backward on the kernels' own O and L: in bf16 the rounding of O
    # moves D = rowsum(dO O) by more than the tolerance
    grads_r = attention_bwd_ref(q, k, v, out, do, L, causal, window)
    torch.cuda.synchronize()
    _held(out, out_r, 2.0 ** -18, dtype)
    _held(L, L_r, 2.0 ** -18, torch.float32)
    for gk, gr in zip(grads, grads_r):
        assert gk.dtype == gr.dtype == dtype
        _held(gk, gr, 2.0 ** -14, dtype)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_is_deterministic(kernel, dtype, dev):
    """dq, dk and dv tiles have one owner block each and no atomics: two
    launches on the same inputs agree bitwise."""
    q, k, v, do = _flash_inputs(3, 2, 256, 14, 2, 64, dtype, dev)
    out, L = fa_ops.flash_attention_fwd(q, k, v, True, 0)
    D = torch.einsum("bshd,bshd->bhs", do.float(), out.float()).contiguous()
    fn = {"dq": fa_ops.flash_attention_dq, "dkv": fa_ops.flash_attention_dkv}
    first = fn[kernel](q, k, v, do, L, D, True, 0)
    second = fn[kernel](q, k, v, do, L, D, True, 0)
    torch.cuda.synchronize()
    if kernel == "dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_function_grads_match_autograd_through_plain_forward(dev):
    q, k, v, do = _flash_inputs(1, 2, 160, 14, 2, 64, torch.float32, dev)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.flash_attention(*a, True, 0).backward(do)
    attention_fwd_ref(*b, True, 0)[0].backward(do)
    for x, y in zip(a, b):
        _held(x.grad, y.grad, 2.0 ** -14, torch.float32)


def test_flash_wrapper_checks_inputs(dev):
    q, k, v, _ = _flash_inputs(2, 1, 64, 4, 2, 32, torch.float32, dev)
    with pytest.raises(TypeError, match="share"):
        fa_ops.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention_fwd(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(q[..., :16].contiguous(),
                                   k[..., :16].contiguous(),
                                   v[..., :16].contiguous())
    with pytest.raises(ValueError, match="S <= Sk"):
        fa_ops.flash_attention_fwd(q, k[:, :32].contiguous(),
                                   v[:, :32].contiguous())


def test_flash_wrapper_refuses_misaligned_bf16(dev):
    """The bf16 kernels load their tiles by TMA, which needs 16-byte
    aligned bases: a contiguous view two bytes into a buffer is refused."""
    q, k, v, _ = _flash_inputs(2, 1, 64, 4, 2, 32, torch.bfloat16, dev)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=dev)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_fwd(shifted, k, v)


def test_smoke_trainer_steps_launch_every_kernel_exactly(dev):
    """Two sync steps at smoke size with per-layer remat, the reference
    pass folded into the rollout: per step the forward kernel runs once per
    layer in the update and once more in the recompute; dq and dk/dv once
    per layer. Each generated token is one fused sample, and each decode
    step one paged attention (the policy) and one decode attention (the
    reference) per layer."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), remat="full")
    tr = EarlTrainer(model=build_model(cfg), env=TicTacToe(), batch_size=4,
                     max_turns=3, max_turn_tokens=4, max_context=96,
                     kl_coef=0.05, clip_eps=0.2)
    assert tr.ref_folded
    params, opt_state, ref = tr.init_state()
    nl, env = cfg.n_layers, tr.env
    for step in range(2):
        for ops in (pa_ops, fs_ops, fa_ops, da_ops):
            ops.reset_launches()
        new, opt_state, rec = tr.run_step(step, params, opt_state, ref)
        assert fa_ops.launches == {"fwd": nl * 2, "dq": nl, "dkv": nl}
        n_macro = fs_ops.launches // tr.max_turn_tokens
        assert fs_ops.launches == n_macro * tr.max_turn_tokens > 0
        decode = nl * (env.obs_len + n_macro * (tr.max_turn_tokens
                                                + env.obs_len))
        assert pa_ops.launches == da_ops.launches == decode
        assert np.isfinite(rec.loss) and rec.kv_dropped_writes == 0
        assert any(not torch.equal(new[k], params[k]) for k in params)
        params = new
    assert all(torch.equal(ref[k], tr.init_state()[0][k]) for k in ref)


def test_dense_rollout_runs_through_the_decode_kernel(smoke):
    """The dense layout with the reference stream: both streams launch the
    split-K kernel once per layer per decode step."""
    model, params, _ = smoke
    eng = CompiledRolloutEngine(model, TicTacToe(), cache_layout="dense",
                                temperature=1.0, max_turns=3,
                                max_turn_tokens=4, max_context=96)
    da_ops.reset_launches()
    fs_ops.reset_launches()
    exp, st = eng.run(params, 4, 8, ref_params=params,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    n_macro = fs_ops.launches // eng.max_turn_tokens
    steps = eng.env.obs_len + n_macro * (eng.max_turn_tokens
                                         + eng.env.obs_len)
    assert da_ops.launches == 2 * model.cfg.n_layers * steps
    assert st.episodes_started == st.episodes_returned == 8
    assert st.pages_in_use == st.page_capacity == 0
    assert bool(torch.isfinite(exp.ref_logprobs).all())


SPEC_CASES = {
    # name: (B, K, NP, P, ps, H, KV, hd, pos or None, int8, drop); drop as
    # in PAGED_CASES, and the kernel's chunks as there.
    "group2": (2, 4, 4, 16, 8, 4, 2, 64, None, False, ()),
    "path_heads_k4": (4, 4, 16, 65, 16, 14, 2, 64, [0, 100, 250, 15], False,
                      ()),
    "k8_two_rows_per_warp": (2, 8, 8, 32, 16, 14, 2, 64, None, False, ()),
    "k16_four_rows_per_warp": (1, 16, 4, 8, 16, 14, 2, 64, [30], False, ()),
    "k1": (3, 1, 4, 16, 8, 4, 2, 32, None, False, ()),
    "mqa_big_page_hd128": (1, 8, 2, 8, 128, 2, 1, 128, [100], False, ()),
    "unmapped_chunk_page": (2, 4, 4, 16, 8, 4, 2, 32, [6, 0], False, ()),
    "int8_scales": (3, 4, 4, 16, 8, 4, 2, 32, None, True, ()),
    # queries ending at a chunk boundary (pos 60), one past it (64), and
    # verify chunks that straddle two kernel chunks (61, 63)
    "pos_at_chunk_edges": (4, 4, 16, 65, 16, 14, 2, 64, [60, 64, 63, 61],
                           False, ()),
    # a kernel chunk whose pages are all unmapped; row 2's queries see
    # only their own chunk's page
    "chunk_all_unmapped": (4, 4, 16, 65, 16, 14, 2, 64, [200, 100, 64, 250],
                           False, ((0, 4, 8), (2, 0, 4))),
    "b1_most_chunks": (1, 4, 64, 64, 16, 14, 2, 64, [1000], False, ()),
    "np128_s2048": (2, 4, 128, 256, 16, 14, 2, 64, [2040, 1000], False, ()),
    # the most rows the kernel takes (16 x 8) at the widest head, 8 chunks
    "max_rows_hd256": (1, 16, 64, 64, 16, 8, 1, 256, [900], False, ()),
    "int8_chunks": (4, 4, 16, 65, 16, 14, 2, 64, [250, 61, 0, 130], True,
                    ()),
}


def _spec_case(seed, B, K, NP, P, ps, H, KV, hd, pos, int8, drop, device):
    """A shuffled block table whose mapped pages cover [0, pos+K) per row,
    less the runs in ``drop``; the unmapped case drops row 0's chunk page
    and all of row 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, K, H, hd), generator=g)
    if int8:
        kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g).to(
            torch.int8)
        vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=g).to(
            torch.int8)
        ks = torch.rand((P, ps, KV), generator=g) / 127
        vs = torch.rand((P, ps, KV), generator=g) / 127
    else:
        kp = torch.randn((P, ps, KV, hd), generator=g)
        vp = torch.randn((P, ps, KV, hd), generator=g)
        ks = vs = None
    pos = (torch.randint(0, NP * ps - K + 1, (B,), generator=g)
           if pos is None else torch.tensor(pos))
    pos = pos.to(torch.int32)
    perm = torch.randperm(P, generator=g)[:B * NP].reshape(B, NP)
    npages = (pos + K + ps - 1) // ps
    bt = torch.where(torch.arange(NP)[None, :] < npages[:, None], perm, -1)
    if B == 2 and pos.tolist() == [6, 0]:
        bt[0, 1] = -1
        bt[1] = -1
    for row, first, end in drop:
        bt[row, first:end] = -1
    out = [q, kp, vp, bt.to(torch.int32).contiguous(), pos, ks, vs]
    return [None if t is None else t.to(device) for t in out]


def _spec_inputs(name, qdtype, dev):
    q, kp, vp, bt, pos, ks, vs = _spec_case(0, *SPEC_CASES[name], dev)
    q = q.to(qdtype)
    if ks is None:
        kp, vp = kp.to(qdtype), vp.to(qdtype)
    return q, kp, vp, bt, pos, ks, vs


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_spec_verify_kernel_matches_plain_version(name, qdtype, dev):
    q, kp, vp, bt, pos, ks, vs = _spec_inputs(name, qdtype, dev)
    n0 = sv_ops.launches
    out = sv_ops.spec_verify_attention(q, kp, vp, bt, pos, k_scales=ks,
                                       v_scales=vs)
    assert sv_ops.launches == n0 + 1
    ref = spec_verify_attention_ref(q, kp, vp, bt, pos, ks, vs)
    torch.cuda.synchronize()
    atol = 2.0 ** -18 * float(ref.float().abs().max())
    rtol = 0.0 if qdtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    if name == "unmapped_chunk_page":
        assert not bool(out[1].any())    # no valid position: zeros


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_spec_verify_queries_equal_the_paged_kernel(name, qdtype, dev):
    """Query j is bitwise the paged kernel's output at lens = pos + j + 1
    on the same pool and q rows."""
    q, kp, vp, bt, pos, ks, vs = _spec_inputs(name, qdtype, dev)
    out = sv_ops.spec_verify_attention(q, kp, vp, bt, pos, k_scales=ks,
                                       v_scales=vs)
    for j in range(q.shape[1]):
        single = pa_ops.paged_decode_attention(
            q[:, j].contiguous(), kp, vp, bt, pos + j + 1, k_scales=ks,
            v_scales=vs)
        assert torch.equal(out[:, j], single), f"query {j}"


@pytest.mark.parametrize("name", ["np128_s2048", "max_rows_hd256"])
def test_spec_verify_is_deterministic(name, dev):
    """Two launches on the same inputs agree bitwise."""
    q, kp, vp, bt, pos, ks, vs = _spec_inputs(name, torch.bfloat16, dev)
    first = sv_ops.spec_verify_attention(q, kp, vp, bt, pos)
    second = sv_ops.spec_verify_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_spec_verify_wrapper_checks_inputs(dev):
    q, kp, vp, bt, pos, _, _ = _spec_inputs("group2", torch.float32, dev)
    with pytest.raises(TypeError, match="int32"):
        sv_ops.spec_verify_attention(q, kp, vp, bt, pos.long())
    with pytest.raises(ValueError, match="contiguous"):
        sv_ops.spec_verify_attention(q.transpose(1, 2).contiguous()
                                     .transpose(1, 2), kp, vp, bt, pos)
    with pytest.raises(ValueError, match="query rows"):
        big = torch.zeros((2, 70, 4, 64), device=dev)   # 140 rows
        sv_ops.spec_verify_attention(big, kp, vp, bt, pos)
    with pytest.raises(ValueError, match="scales"):
        sv_ops.spec_verify_attention(q, kp.to(torch.int8),
                                     vp.to(torch.int8), bt, pos)


@pytest.fixture
def spec_smoke(smoke):
    """The smoke engine with speculation="self" (one draft layer), and a
    count of its verify rounds (one host read each)."""
    model, params, _ = smoke
    eng = CompiledRolloutEngine(
        model, TicTacToe(), kv_dtype="fp32", temperature=1.0, max_turns=3,
        max_turn_tokens=4, max_context=96, sampling="reference",
        speculation="self", spec_k=3, draft_layers=1)
    rounds = []
    more = eng._more_rounds

    def counted(pending):
        rounds.append(1)
        return more(pending)
    eng._more_rounds = counted
    return model, params, eng, rounds


def test_spec_rollout_launches_the_verify_kernel_per_round(spec_smoke):
    model, params, eng, rounds = spec_smoke
    sv_ops.reset_launches()
    fs_ops.reset_launches()
    exp, st = eng.run(params, 4, 8,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    assert len(rounds) > 0
    assert sv_ops.launches == model.cfg.n_layers * len(rounds)
    assert fs_ops.launches == 0
    assert st.episodes_started == st.episodes_returned == 8
    assert st.kv_dropped_writes == 0 and st.spec_rounds > 0
    assert 0 <= st.spec_accepted <= st.spec_proposed
    assert bool(torch.isfinite(exp.logprobs).all())


def test_spec_macro_step_syncs_once_per_round(spec_smoke):
    """Nothing in a speculative macro-step syncs with the host except the
    round helper, once per verify round."""
    _, params, eng, rounds = spec_smoke
    carry = eng.init_feed(params, eng.init_carry(4, 8))
    noise = eng.default_noise(torch.Generator(device="cuda").manual_seed(2))
    more = eng._more_rounds

    def allowed(pending):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return more(pending)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    eng._more_rounds = allowed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = eng.turn_step(params, carry, 0, noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert 1 <= len(rounds) <= eng.max_turn_tokens
    assert int(carry.spec_rounds) > 0


SSD_CASES = {
    # name: (b, s, h, g, p, n, chunk)
    "ragged_s100": (2, 100, 4, 1, 32, 16, 32),
    "groups4_p64": (2, 96, 8, 4, 64, 32, 64),
    "wide_state_n128": (1, 128, 2, 1, 64, 128, 64),
    "p16_n8_groups2": (1, 40, 4, 2, 16, 8, 16),
    "p128_ragged_chunk": (1, 130, 2, 1, 128, 128, 128),
    "s_below_chunk": (2, 20, 4, 1, 32, 16, 64),
    "mamba2_heads_chunk256": (2, 600, 32, 1, 64, 128, 256),
    "mamba2_score_b2": (2, 512, 32, 1, 64, 128, 256),
    "heads3_per_group": (2, 200, 6, 2, 64, 64, 64),
    "p128_n128_chunk256": (2, 512, 4, 1, 128, 128, 256),
    "p64_chunk32_ragged": (2, 72, 4, 1, 64, 64, 32),
}


def _ssd_inputs(seed, b, s, h, g, p, n, dtype, device, offset=0):
    """x, B and C as strided views of one (b, s, h*p + 2*g*n) tensor, the
    layout the mixer hands the kernel (``offset`` elements into a wider
    one: views off a 16-byte boundary); dt softplus'ed, A negative."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xbc = (torch.randn((b, s, h * p + 2 * g * n + offset), generator=gen)
           * 0.5).to(device=device, dtype=dtype)[..., offset:]
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    C = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    A = -torch.exp(torch.randn((h,), generator=gen) * 0.3)
    return x, dt.to(device), A.to(device), B, C


@pytest.mark.parametrize("name", sorted(SSD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(name, dtype, dev):
    b, s, h, g, p, n, chunk = SSD_CASES[name]
    x, dt, A, B, C = _ssd_inputs(0, b, s, h, g, p, n, dtype, dev)
    n0 = ssd_ops.launches
    y, fin = ssd_ops.ssd_scan(x, dt, A, B, C, chunk)
    assert ssd_ops.launches == n0 + 1
    yr, finr = ssd_ref(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert y.shape == (b, s, h, p) and y.dtype == dtype
    assert fin.shape == (b, h, p, n) and fin.dtype == torch.float32
    sy, sf = float(yr.float().abs().max()), float(finr.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(y, yr, atol=2.0 ** -18 * sy, rtol=0)
    else:
        torch.testing.assert_close(y.float(), yr.float(),
                                   atol=2.0 ** -6 * sy, rtol=2.0 ** -7)
    torch.testing.assert_close(fin, finr, atol=2.0 ** -18 * sf, rtol=0)


def _ssd_route(x, B, C, chunk):
    b, s, h, p = x.shape
    return ssd_ops.plan(x.dtype, p, B.shape[3], min(chunk, s),
                        h // B.shape[2], b * h,
                        torch.cuda.get_device_properties(
                            x.device).multi_processor_count,
                        ssd_ops._tma_ready(x, B, C))


def test_ssd_scan_misaligned_view_takes_the_f32_route(dev):
    """x, B and C one element off a 16-byte boundary: TMA cannot read
    them, so the plan takes the f32 route, which reads by element."""
    x, dt, A, B, C = _ssd_inputs(2, 2, 256, 4, 1, 64, 128, torch.bfloat16,
                                 dev, offset=1)
    assert x.data_ptr() % 16 and _ssd_route(x, B, C, 64)[0] == ssd_ops.SIMT
    y, fin = ssd_ops.ssd_scan(x, dt, A, B, C, 64)
    yr, finr = ssd_ref(x, dt, A, B, C, 64)
    sy, sf = float(yr.float().abs().max()), float(finr.abs().max())
    torch.testing.assert_close(y.float(), yr.float(), atol=2.0 ** -6 * sy,
                               rtol=2.0 ** -7)
    torch.testing.assert_close(fin, finr, atol=2.0 ** -18 * sf, rtol=0)


@pytest.mark.parametrize("name,dtype", [
    ("mamba2_score_b2", torch.bfloat16), ("mamba2_score_b2", torch.float32),
    ("p64_chunk32_ragged", torch.bfloat16)])
def test_ssd_scan_is_deterministic(name, dtype, dev):
    """No atomics on either route: two launches give the same bits."""
    b, s, h, g, p, n, chunk = SSD_CASES[name]
    x, dt, A, B, C = _ssd_inputs(3, b, s, h, g, p, n, dtype, dev)
    y1, f1 = ssd_ops.ssd_scan(x, dt, A, B, C, chunk)
    y2, f2 = ssd_ops.ssd_scan(x, dt, A, B, C, chunk)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


@pytest.mark.parametrize("route,ht", [(0, 1), (0, 2), (1, 1), (1, 2)])
def test_ssd_scan_every_head_tile_matches_plain_version(route, ht, dev):
    """Each route and head tile the plan may choose, at mamba2's score
    widths, through the private launch the head-tile probe uses."""
    b, s, h, g, p, n, chunk = SSD_CASES["mamba2_score_b2"]
    x, dt, A, B, C = _ssd_inputs(4, b, s, h, g, p, n, torch.bfloat16, dev)
    dA = (dt * A[None, None, :]).contiguous()
    y, fin = ssd_ops._launch(x, dt.contiguous(), dA, B, C, chunk, (route, ht))
    yr, finr = ssd_ref(x, dt, A, B, C, chunk)
    sy, sf = float(yr.float().abs().max()), float(finr.abs().max())
    torch.testing.assert_close(y.float(), yr.float(), atol=2.0 ** -6 * sy,
                               rtol=2.0 ** -7)
    torch.testing.assert_close(fin, finr, atol=2.0 ** -18 * sf, rtol=0)


def test_ssd_scan_smem_formula_matches_the_kernel(dev):
    """ops.smem_bytes, which the plan and the CPU tests use, is the
    kernel's own count for every route, head width, state and chunk."""
    import ctypes
    from repro_torch.kernels import _build
    fn = _build.load("ssd_scan").ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for route in (0, 1):
        for p in (16, 32, 64, 128):
            for n in (8, 16, 32, 64, 128):
                for q in (16, 64, 256, 1024):
                    for ht in (1, 2):
                        assert fn(route, p, n, q, ht) == ssd_ops.smem_bytes(
                            route, p, n, q, ht), (route, p, n, q, ht)


def test_ssd_scan_wrapper_checks_inputs(dev):
    x, dt, A, B, C = _ssd_inputs(1, 1, 32, 2, 1, 32, 16, torch.float32,
                                 dev)
    with pytest.raises(ValueError, match="zero state"):
        ssd_ops.ssd_scan(x, dt, A, B, C, 16,
                         initial_state=torch.zeros((1, 2, 32, 16),
                                                   device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_scan(x.detach().requires_grad_(True), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_scan(x[..., :24], dt, A, B, C, 16)
    with pytest.raises(ValueError, match="state"):
        wide = torch.zeros((1, 32, 1, 129), device=dev)
        ssd_ops.ssd_scan(x, dt, A, wide, wide, 16)
    with pytest.raises(TypeError, match="share"):
        ssd_ops.ssd_scan(x, dt, A, B.to(torch.bfloat16),
                         C.to(torch.bfloat16), 16)
    with pytest.raises(ValueError, match="last dim"):
        ssd_ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, B, C, 16)


def test_ssm_smoke_paths_launch_exactly(dev):
    """mamba2 at smoke size on the card: one trainer step folds the
    reference (fused sampling per generated token, no SSD scan: the update
    runs the chunked form under autograd, as JAX's), and ExpPrep's
    standalone pass launches the SSD scan once per layer and agrees with
    the plain pass within 2e-4 (f32 params, bf16 conv caches only in the
    rollout)."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), remat="full")
    model = build_model(cfg)
    tr = EarlTrainer(model=model, env=TicTacToe(), batch_size=4,
                     rollout_episodes=8, max_turns=3, max_turn_tokens=4,
                     max_context=96, kl_coef=0.05, clip_eps=0.2)
    assert tr.cache_layout == "dense" and tr.ref_folded
    params, opt_state, ref = tr.init_state()
    for ops in (ssd_ops, fs_ops, pa_ops, da_ops, fa_ops):
        ops.reset_launches()
    new, _, rec = tr.run_step(0, params, opt_state, ref)
    n_macro = fs_ops.launches // tr.max_turn_tokens
    assert fs_ops.launches == n_macro * tr.max_turn_tokens > 0
    assert ssd_ops.launches == pa_ops.launches == da_ops.launches == 0
    assert fa_ops.launches == {"fwd": 0, "dq": 0, "dkv": 0}
    assert np.isfinite(rec.loss) and np.isfinite(rec.kl)
    exp, _ = tr.rollout.run(new, 4, 8, generator=torch.Generator(
        device="cuda").manual_seed(3))
    p32 = {k: v.float() for k, v in new.items()}
    alone = tr.expprep_stage(exp, ref_params=p32, ref_folded=False)
    assert ssd_ops.launches == cfg.n_layers
    plain = ExpPrepStage(model)(exp, ref_params=p32, ref_folded=False)
    torch.testing.assert_close(alone.ref_logprobs, plain.ref_logprobs,
                               atol=2e-4, rtol=0)
