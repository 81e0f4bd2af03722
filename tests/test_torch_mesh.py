"""The port's rank groups (``parallel/mesh.py``) on CPU gloo ranks, against
plain tensor ops (no JAX).

* ``all_gather``, ``all_to_all`` (tiled, as ``jax.lax``'s), ``ppermute``
  (a ring, a chain: the rank no pair reaches gets zeros) and
  ``broadcast`` over 2 and 4 ranks, on bf16 and f32: bit-equal to the
  same concatenations, chunks and shifts of the ranks' tensors built
  in the parent; the counts by kind.
* ``axis_groups``: a (data=2, model=2) layout over 4 ranks, the last
  axis fastest, each axis's group gathering its members in order.
* A group of one rank: every collective the identity, no process group.
* The refusals: an axis outside ``AXES``, chunks that do not divide,
  pairs that are not a permutation, a layout that does not hold the
  ranks.

Tolerance: bit-exact everywhere (the collectives move bits, they sum
nothing).
"""

import pytest
import torch

import torch_ranks
from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu_torch.parallel import RankGroup, spawn


def _tensor(rank: int, world: int, dt) -> torch.Tensor:
    """torch_ranks.collectives' tensor of ``rank``."""
    return (torch.arange(2 * 4 * world, dtype=torch.float32).reshape(2, 4 * world)
            + 1000 * rank).to(dt)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_plain_tensor_ops(world):
    ranks = spawn(torch_ranks.collectives, world, device="cpu")
    for dt in (torch.bfloat16, torch.float32):
        ts = [_tensor(r, world, dt) for r in range(world)]
        for r, out in enumerate(ranks):
            got = out[str(dt)]
            assert torch.equal(got["all_gather"], torch.cat(ts, 1))
            assert torch.equal(got["all_to_all"], torch.cat(
                [t.chunk(world, 1)[r] for t in ts], 0))
            assert torch.equal(got["ring"], ts[(r - 1) % world])
            want = ts[r - 1] if r else torch.zeros_like(ts[0])
            assert torch.equal(got["chain"], want)
            assert torch.equal(got["broadcast"], ts[world - 1])
            assert got["all_gather"].dtype == dt
    for out in ranks:
        assert out["counts"] == {"all_gather": 2, "all_to_all": 2,
                                 "ppermute": 4, "broadcast": 2}
    if world == 4:
        for r, out in enumerate(ranks):
            d, m = divmod(r, 2)
            assert out["layout"]["data"] == (d, 2, [float(m), float(m + 2)])
            assert out["layout"]["model"] == (m, 2, [float(2 * d),
                                                     float(2 * d + 1)])


def test_a_group_of_one_rank_is_the_identity():
    g = RankGroup.single("stage", "cpu")
    t = torch.randn(3, 4)
    assert torch.equal(g.all_gather(t, 1), t)
    assert torch.equal(g.all_to_all(t, 1, 0), t)
    assert torch.equal(g.ppermute(t, [(0, 0)]), t)
    assert torch.equal(g.ppermute(t, []), torch.zeros_like(t))
    assert torch.equal(g.broadcast(t.clone(), 0), t)
    assert torch.equal(g.all_reduce(t.clone()), t)
    assert g.counts == {"all_gather": 1, "all_to_all": 1, "ppermute": 2,
                        "broadcast": 1, "all_reduce": 1}
    assert g.reduces == 1 and g.staged == set()
    g.staged.add("ppermute")
    g.reset_counts()
    assert g.reduces == 0 and not g.counts and not g.staged


def test_refusals():
    with pytest.raises(ValueError, match="axis"):
        RankGroup.single("pipeline", "cpu")
    g = RankGroup(world=2, rank=0, axis="seq", device=torch.device("cpu"),
                  backend="gloo")
    with pytest.raises(ValueError, match="do not divide"):
        g.all_to_all(torch.zeros(3, 3), 1, 0)
    with pytest.raises(ValueError, match="not a permutation"):
        g.ppermute(torch.zeros(2), [(0, 1), (1, 1)])
    from micromix_tpu_torch.parallel import axis_groups
    with pytest.raises(ValueError, match="does not hold"):
        axis_groups(g, data=2, model=2)
