from .pnp import solve_planar_pnp, solve_planar_pnp_dual, poses_from_detections

__all__ = ["solve_planar_pnp", "solve_planar_pnp_dual", "poses_from_detections"]
