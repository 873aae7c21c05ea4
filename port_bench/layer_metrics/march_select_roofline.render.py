"""``march_select_roofline.render``: the march's slot selection and
re-selection kernels (``fused_select_grouped``, K5; ``fused_reselect``,
K6) as a share of their roofline over the traced views: the summed least
times of the views' chunks over the kernels' summed device times.

A view's rays go in chunks of ``test_chunk_size`` (the last one holds
the rest, and is counted at its own rays, not at a padded chunk's).
Selection reads each ray's G group counts (4 bytes), its group size and
t_min (4 bytes each) and writes K slots' start, end and width (4 bytes
each) and mask (1 byte); re-selection reads K slots' mask, start, end
and width and writes K2 of them. No arithmetic worth counting: the least
time is the bytes at 3.35 TB/s. On the view path at ``coarse_stride`` 1
only re-selection runs, and only it is counted. Moves
``render_rays_per_s``."""

from ..harness import roofline

SELECT, RESELECT = "select_grouped_kernel", "reselect_kernel"


def select_bytes(rays: int, groups: int, slots: int) -> int:
    return rays * (groups * 4 + 8) + rays * slots * 13


def reselect_bytes(rays: int, slots: int, slots2: int) -> int:
    return rays * (slots + slots2) * 13


def read(ctx):
    v = ctx["cell"].config["view"]
    chunk = v["test_chunk_size"]
    slots = min(v["max_samples_per_ray"], v["eval_samples_per_ray"])
    slots2 = min(slots, v["eval_visible_samples_per_ray"])
    groups = v.get("probe_groups") or (v["max_samples_per_ray"]
                                       // max(v["coarse_stride"], 1))
    device = sum(e["dur"] for e in ctx["trace"].kernels
                 if SELECT in e["name"] or RESELECT in e["name"]) * 1e-6
    if device <= 0:
        return None
    n_rays = ctx["runner"].rays[0][0].shape[0]
    moved = 0
    for start in range(0, n_rays, chunk):
        rays = min(chunk, n_rays - start)
        moved += reselect_bytes(rays, slots, slots2)
        if v["coarse_stride"] > 1:
            moved += select_bytes(rays, groups, slots)
    least = ctx["trace"].units * roofline.least_seconds(0, moved)
    return 100.0 * least / device
