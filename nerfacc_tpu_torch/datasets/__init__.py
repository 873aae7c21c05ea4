from .procedural import ProceduralScene, render_gt
from .rays import Rays, generate_rays, look_at_poses

__all__ = ["ProceduralScene", "Rays", "generate_rays", "look_at_poses",
           "render_gt"]
