"""Hough vote accumulation: the port's plain version and wrapper against the
JAX package's `_votes_jax` and its Pallas kernel (interpret mode). The CUDA
kernel against the plain version is in tests/test_torch_cuda.py.

Vote counts are integers summed in float32, so they must match exactly;
depth sums run in another order, so they are held to rtol 1e-5, atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.ops.pallas.voting import _votes_jax, accumulate_votes_slots
from posecnn_torch.ops import voting as V
from tests.torch_parity import t, vote_edge_cases, vote_samples

torch.set_num_threads(1)

S, P, H, W = 3, 128, 24, 32
NC = 300  # not a multiple of the Pallas block (128)


def _inputs(per_slot: bool, seed: int = 3):
    rng = np.random.RandomState(seed)
    samples = vote_samples(rng, S, P, W, H)
    n = S if per_slot else 1
    cx = rng.randint(0, W, (n, NC)).astype(np.float32)
    cy = rng.randint(0, H, (n, NC)).astype(np.float32)
    return samples, np.stack([cx, cy], axis=1)  # (n, 2, NC)


def _jax_per_slot(fn, samples, centers):
    """Run a JAX (2, NC)-centre function once per slot when centres are per slot."""
    if centers.shape[0] == 1:
        v, d = fn(jnp.asarray(samples), jnp.asarray(centers[0]))
        return np.asarray(v), np.asarray(d)
    outs = [fn(jnp.asarray(samples[s:s + 1]), jnp.asarray(centers[s])) for s in range(samples.shape[0])]
    return np.concatenate([np.asarray(o[0]) for o in outs]), np.concatenate([np.asarray(o[1]) for o in outs])


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_plain_matches_votes_jax(per_slot):
    samples, centers = _inputs(per_slot)
    v_ref, d_ref = _jax_per_slot(_votes_jax, samples, centers)
    v, d = V.accumulate_votes_plain(t(samples), t(centers))
    assert v_ref.sum() > 0
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared", "per_slot"])
def test_plain_matches_pallas_interpret(per_slot):
    samples, centers = _inputs(per_slot, seed=4)

    def pallas(s, c):
        return accumulate_votes_slots(s, c, use_pallas=True, interpret=True, block=128)

    v_ref, d_ref = _jax_per_slot(pallas, samples, centers)
    v, d = V.accumulate_votes(t(samples), t(centers))
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("reference", ["votes_jax", "pallas_interpret"])
@pytest.mark.parametrize("case", vote_edge_cases(), ids=lambda c: c[0])
def test_plain_matches_jax_on_pruning_edges(case, reference):
    """The cases that hold the CUDA kernel's box pruning to the plain version
    on the card (tests/test_torch_cuda.py): here the plain version, and the
    wrapper on a CPU tensor with the grid width, against `_votes_jax` and the
    Pallas kernel in interpret mode on the same edges."""
    _, samples, centers, grid_w = case
    if reference == "votes_jax":
        v_ref, d_ref = _jax_per_slot(_votes_jax, samples, centers)
    else:
        v_ref, d_ref = _jax_per_slot(
            lambda s, c: accumulate_votes_slots(s, c, use_pallas=True, interpret=True, block=128), samples, centers)
    v, d = V.accumulate_votes(t(samples), t(centers), grid_w=grid_w)
    v_p, d_p = V.accumulate_votes_plain(t(samples), t(centers))
    assert torch.equal(v, v_p) and torch.equal(d, d_p)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-5, atol=1e-4)


def test_pruning_edges_vote_where_the_box_reaches():
    """The box-edge case: each sample whose box edge lies exactly on the
    grid's extreme centres votes nowhere, and its twin one ulp wider votes
    only for centres on that edge (|dx| or |dy| equal to the edge)."""
    _, samples, centers, _ = next(c for c in vote_edge_cases() if c[0] == "box_edge")
    cx, cy = t(centers[0, 0]), t(centers[0, 1])
    for i in range(samples.shape[2]):
        v, _ = V.accumulate_votes_plain(t(samples[:, :, i:i + 1]), t(centers))
        if i % 2 == 0:
            assert int(v.sum()) == 0
            continue
        edge = float(samples[0, 5, i - 1])
        hit = v[0] > 0
        assert int(hit.sum()) > 0
        dx, dy = (cx[hit] - float(samples[0, 0, i])).abs(), (cy[hit] - float(samples[0, 1, i])).abs()
        assert bool(((dx == edge) | (dy == edge)).all())


def test_cpu_tensor_takes_plain_version():
    samples, centers = _inputs(False)
    before = V.VOTE_LAUNCHES
    v, d = V.accumulate_votes(t(samples), t(centers))
    v2, d2 = V.accumulate_votes_plain(t(samples), t(centers))
    assert V.VOTE_LAUNCHES == before
    assert torch.equal(v, v2) and torch.equal(d, d2)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "rows", "centers_slots", "centers_rows", "noncontiguous", "grid_w"],
)
def test_wrapper_rejects_bad_input(bad):
    samples, centers = _inputs(True)
    s, c = t(samples), t(centers)
    if bad == "dtype":
        s = s.double()
    elif bad == "rows":
        s = s[:, :7].contiguous()
    elif bad == "centers_slots":
        c = torch.cat([c, c[:1]])  # S+1 sets of centres
    elif bad == "centers_rows":
        c = torch.cat([c, c[:, :1]], dim=1)
    elif bad == "noncontiguous":
        s = s.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises((TypeError, ValueError)):
        V.accumulate_votes(s, c, grid_w=-1 if bad == "grid_w" else 0)
