from .rays import Rays, generate_rays, look_at_poses

__all__ = ["Rays", "generate_rays", "look_at_poses"]
