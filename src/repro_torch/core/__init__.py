from repro_torch.core.resharding import (
    MeshConfig,
    NamedLayout,
    logical_to_physical,
    param_shardings,
    reshard,
)
from repro_torch.core.parallelism_selector import (
    ParallelismSelector,
    SelectorPolicy,
    ContextBuckets,
)
from repro_torch.core.data_dispatcher import (
    DataDispatcher,
    DispatchReport,
    MovementPlan,
    movement_plan,
    centralized_plan,
    estimate_latency,
    all_to_all_resplit,
)
from repro_torch.core.train_step import (
    make_rl_train_step,
    make_ref_logprob_step,
)
from repro_torch.core.scheduler import PipelineSchedule
from repro_torch.core.stages import (
    DispatchStage,
    EarlTrainer,
    ExpPrepStage,
    RolloutStage,
    StepRecord,
    UpdateStage,
)
