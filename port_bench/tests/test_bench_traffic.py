"""The frozen traffic: one seed gives the same batches, views and order
twice; another seed gives others of the same sizes."""

import torch

from port_bench.harness import scene, traffic
from port_bench.tests import small


def test_train_batches_follow_the_seed():
    tr = small.small_cell("instant_ngp.train").traffic
    a = traffic.train_batches(tr, 16, 2 ** 31 + 11, "cpu")
    b = traffic.train_batches(tr, 16, 2 ** 31 + 11, "cpu")
    c = traffic.train_batches(tr, 16, 12, "cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert x.shape == z.shape == (tr["episode_steps"], 16, 3)
        assert not torch.equal(x, z)
    assert float(a[2].min()) >= 0.0 and float(a[2].max()) <= 1.0


def test_view_order_follows_the_seed():
    tr = small.small_cell("instant_ngp.view").traffic
    rays, order = traffic.view_requests(tr, 7, "cpu")
    rays2, order2 = traffic.view_requests(tr, 7, "cpu")
    orders = {tuple(traffic.view_requests(tr, s, "cpu")[1])
              for s in range(8)}
    assert order == order2 and sorted(order) == list(range(len(rays)))
    assert len(orders) > 1
    for (o, d), (o2, d2) in zip(rays, rays2):
        assert torch.equal(o, o2) and torch.equal(d, d2)
        assert torch.allclose(d.norm(dim=-1), torch.ones(d.shape[0]))


def test_ground_truth_sees_the_scene():
    poses = scene.ring_poses([[20.0, 4]], 3.2)
    K = scene.intrinsics(16, 16, 45.0)
    yy, xx = torch.meshgrid(torch.arange(16), torch.arange(16),
                            indexing="ij")
    o, d = scene.pixel_rays(xx.reshape(-1), yy.reshape(-1), poses[0], K)
    px = scene.ground_truth(o, d, 128)
    # the centre of the view sees the blobs, the corners the background
    assert float(px[8 * 16 + 8].sum()) < 2.5
    assert torch.allclose(px[0], torch.ones(3), atol=1e-3)


def test_subseeds_differ_by_use_and_fit_a_generator():
    seeds = {traffic.subseed(2 ** 31 + 5, tag) for tag in ("a", "b", "c")}
    assert len(seeds) == 3 and max(seeds) < 2 ** 62
