from .procedural import (
    ProceduralDynamicScene,
    ProceduralScene,
    render_gt,
    render_gt_dynamic,
)
from .rays import Rays, generate_rays, look_at_poses

__all__ = ["ProceduralDynamicScene", "ProceduralScene", "Rays",
           "generate_rays", "look_at_poses", "render_gt",
           "render_gt_dynamic"]
