from .state import (  # noqa: F401
    AdamState,
    GaussianState,
    adam_from_numpy,
    adam_update,
    camera_from_numpy,
    expon_lr,
    from_gaussian_data,
    from_point_cloud,
    get_color,
    get_normal,
    grow_capacity,
    init_adam,
    raster_inputs,
    rgb_to_sh_inv,
    round_capacity,
    state_from_numpy,
    to_gaussian_data,
)
from .densify import accumulate_stats, count_densify_candidates, densify_and_prune, reset_opacity  # noqa: F401
from .refine import FROZEN_REFINE, refine_step  # noqa: F401
from .step import OptParams, StepMetrics, train_step  # noqa: F401
from .step2d import Opt2DParams, train_step_2d  # noqa: F401
