"""Camera-batch scale-out on torch.distributed, port of `scorp_tpu.parallel`:
process groups (`mesh`), the data-parallel training steps (`train_dp`),
camera-parallel eval rendering (`render_dp`) and a multi-process check on
CPU ranks (`python -m scorp_tpu_torch.parallel.dryrun <n>`)."""

from .mesh import Group, free_port, make_group, replicate, shard_batch  # noqa: F401
from .render_dp import dp_render  # noqa: F401
from .train_dp import dp_train_step, dp_train_step_2d, stack_cameras  # noqa: F401
