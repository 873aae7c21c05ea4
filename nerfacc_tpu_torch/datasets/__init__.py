from .procedural import (
    Procedural360Scene,
    ProceduralDynamicScene,
    ProceduralScene,
    env_color,
    render_gt,
    render_gt_dynamic,
    render_gt_env,
)
from .rays import Rays, generate_rays, look_at_poses

__all__ = ["Procedural360Scene", "ProceduralDynamicScene", "ProceduralScene",
           "Rays", "env_color", "generate_rays", "look_at_poses", "render_gt",
           "render_gt_dynamic", "render_gt_env"]
