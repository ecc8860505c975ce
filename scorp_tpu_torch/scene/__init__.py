from .cameras import Camera, GroundTruth, MiniCam, load_ground_truth  # noqa: F401
from .dataset_readers import (  # noqa: F401
    CameraInfo,
    SceneInfo,
    read_colmap_scene,
    read_toydesk_scene,
    resolve_resolution,
)
from .scene import Scene, search_max_iteration  # noqa: F401
