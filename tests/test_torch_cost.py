"""``torch_cost`` against ``jax_cost`` on a dense grid over a mixed-L
padded batch (VGG19 L=37, ResNet101 L=36 and one LM arch, Kimi K2 L=61,
which sets the pad width). Floats agree within float32 rtol 1e-6 (atol
1e-6 of each quantity's scale, for values that cancel to near zero);
split indices, quantized accuracies and feasibility bits are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as ref_acq
from repro.core import batch_bo as ref_batch
from repro.core import jax_cost
from repro_torch.core import acquisition as port_acq
from repro_torch.core import batch_bo as port_batch
from repro_torch.core import torch_cost
from repro_torch.interop import from_reference

torch.set_num_threads(1)
ARCHS = ("vgg19", "resnet101", "kimi-k2-1t-a32b")
RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.max(np.abs(want[fin])) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * scale)


@pytest.fixture(scope="module")
def surfaces():
    gains = (0.0, -2.0, 1.0)
    ref_pbs = [ref_batch.scenario_from_request(a, g).problem
               for a, g in zip(ARCHS, gains)]
    port_pbs = [port_batch.scenario_from_request(a, g).problem
                for a, g in zip(ARCHS, gains)]
    l_pad = max(pb.L for pb in port_pbs)
    ref_p = jax_cost.stack_params([pb.jax_params() for pb in ref_pbs],
                                  l_pad=l_pad)
    port_p = torch_cost.stack_params(
        [pb.device_params(device="cpu") for pb in port_pbs], l_pad=l_pad)
    xs = np.linspace(0.0, 1.0, 41)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    # a few points outside [0, 1] exercise the clip
    grid = np.concatenate([grid, [[-0.3, 1.4], [1.2, -0.1]]])
    A = np.broadcast_to(grid, (len(ARCHS),) + grid.shape).astype(np.float32)
    return dict(ref_p=ref_p, port_p=port_p, A=A, ref_pbs=ref_pbs,
                port_pbs=port_pbs, l_pad=l_pad)


def _ref(fn, *args):
    """The reference function vmapped over the scenario axis, as numpy."""
    out = jax.vmap(fn)(*args)
    if isinstance(out, tuple):
        return tuple(np.asarray(v) for v in out)
    return np.asarray(out)


def test_make_params_equal_reference_after_interop(surfaces):
    ref_np = {k: np.asarray(v) for k, v in surfaces["ref_p"].items()}
    carried = from_reference(ref_np, "cpu")
    port = surfaces["port_p"]
    assert carried.keys() == port.keys()
    for k in port:
        assert carried[k].dtype == port[k].dtype, k
        assert torch.equal(carried[k], port[k]), k


def test_pad_params_and_valid_split(surfaces):
    pb = surfaces["port_pbs"][1]
    l_pad = surfaces["l_pad"]
    padded = torch_cost.pad_params(pb.device_params(device="cpu"), l_pad)
    direct = torch_cost.make_params(pb, l_pad, "cpu")
    for k in direct:
        assert torch.equal(padded[k], direct[k]), k
    li = torch.arange(-1, l_pad + 2)
    ref = np.asarray(jax_cost.valid_split(
        jax.tree.map(lambda v: v[1], surfaces["ref_p"]), jnp.asarray(li)))
    got = torch_cost.valid_split({k: v[1] for k, v in
                                  surfaces["port_p"].items()}, li)
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        torch_cost.stack_params([direct], l_pad=pb.L - 1)


def test_denormalize_energy_delay_penalty(surfaces):
    ref_p, port_p, A = surfaces["ref_p"], surfaces["port_p"], surfaces["A"]
    rli, rp = _ref(jax_cost.denormalize, ref_p, jnp.asarray(A))
    pli, pp = torch_cost.denormalize(port_p, torch.as_tensor(A))
    np.testing.assert_array_equal(pli.numpy(), rli)
    _close(pp.numpy(), rp)
    re, rt = _ref(jax_cost.energy_delay, ref_p, jnp.asarray(rli),
                  jnp.asarray(rp))
    pe, pt = torch_cost.energy_delay(port_p, pli, pp)
    _close(pe.numpy(), re)
    _close(pt.numpy(), rt)
    _close(torch_cost.penalty(port_p, torch.as_tensor(A)).numpy(),
           _ref(jax_cost.penalty, ref_p, jnp.asarray(A)))


def test_utility_is_equal(surfaces):
    ref_p, port_p, A = surfaces["ref_p"], surfaces["port_p"], surfaces["A"]
    rli, rp = _ref(jax_cost.denormalize, ref_p, jnp.asarray(A))
    ru, racc, rfeas = _ref(jax_cost.utility, ref_p, jnp.asarray(rli),
                           jnp.asarray(rp))
    pli, pp = torch_cost.denormalize(port_p, torch.as_tensor(A))
    pu, pacc, pfeas = torch_cost.utility(port_p, pli, pp)
    _close(pu.numpy(), ru)
    np.testing.assert_array_equal(pacc.numpy(), racc)
    np.testing.assert_array_equal(pfeas.numpy(), rfeas)
    assert rfeas.any() and not rfeas.all()


def test_normalize_round_trip_and_seen_key(surfaces):
    ref_p, port_p, A = surfaces["ref_p"], surfaces["port_p"], surfaces["A"]
    rli, rp = _ref(jax_cost.denormalize, ref_p, jnp.asarray(A))
    pli, pp = torch_cost.denormalize(port_p, torch.as_tensor(A))
    _close(torch_cost.normalize(port_p, pli, pp).numpy(),
           _ref(jax_cost.normalize, ref_p, jnp.asarray(rli),
                jnp.asarray(rp)))
    # half-to-even rounding on exact ties, as jnp.round
    ties = torch.tensor([0.0005, 0.0015, 0.0025, 0.1235, 0.3845])
    np.testing.assert_array_equal(
        torch_cost.seen_key(ties).numpy(),
        np.asarray(jax_cost.seen_key(jnp.asarray(ties.numpy()))))
    np.testing.assert_array_equal(
        torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])).numpy(),
        np.asarray(jnp.rint(jnp.asarray([0.5, 1.5, 2.5, -0.5, -1.5]))))
    for x in (0.125, 0.375, 1.0625, 7.3):
        assert (torch_cost.quantize_key(x, 0.25)
                == jax_cost.quantize_key(x, 0.25))


def test_project_feasible_per_point(surfaces):
    """The reference projects one point per scenario (vmapped); the port
    takes the whole block at once."""
    ref_p, port_p, A = surfaces["ref_p"], surfaces["port_p"], surfaces["A"]
    one = jax.vmap(jax.vmap(jax_cost.project_feasible, in_axes=(None, 0)))
    ref = np.asarray(one(ref_p, jnp.asarray(A)))
    got = torch_cost.project_feasible(port_p, torch.as_tensor(A)).numpy()
    _close(got, ref)
    rli, _ = _ref(jax_cost.denormalize, ref_p, jnp.asarray(ref))
    pli, _ = torch_cost.denormalize(port_p, torch.as_tensor(got))
    np.testing.assert_array_equal(pli.numpy(), rli)


def test_fallback_answer(surfaces):
    ref_p, port_p = surfaces["ref_p"], surfaces["port_p"]
    best = np.array([[0.3, 0.2], [0.6, 0.9], [0.1, 0.05]], np.float32)
    has = np.array([True, False, False])
    ra, ru, rf = _ref(jax_cost.fallback_answer, ref_p, jnp.asarray(best),
                      jnp.asarray(has))
    pa, pu, pf = torch_cost.fallback_answer(port_p, torch.as_tensor(best),
                                            torch.as_tensor(has))
    _close(pa.numpy(), ra)
    _close(pu.numpy(), ru)
    np.testing.assert_array_equal(pf.numpy(), rf)


def test_gather_clips_out_of_range_index(surfaces):
    """JAX indexing wraps a negative split index and clamps one past the
    end; the port does the same before the gather (a CUDA gather would
    assert instead)."""
    ref_p, port_p = surfaces["ref_p"], surfaces["port_p"]
    li = np.array([[-5, 0, 200]] * len(ARCHS))
    p = np.full(li.shape, 0.3, np.float32)
    re, rt = _ref(jax_cost.energy_delay, ref_p, jnp.asarray(li, jnp.int32),
                  jnp.asarray(p))
    pe, pt = torch_cost.energy_delay(port_p, torch.as_tensor(li),
                                     torch.as_tensor(p))
    _close(pe.numpy(), re)
    _close(pt.numpy(), rt)


def test_local_and_assembled_candidates_on_device(surfaces):
    ref_p, port_p = surfaces["ref_p"], surfaces["port_p"]
    inc = np.array([[0.76, 6 / 36], [0.2, 0.5], [0.9, 1.0]], np.float32)
    has = np.array([True, True, False])
    grid = port_acq.candidate_grid(16).astype(np.float32)
    fill = jnp.asarray(grid[0])
    ref_loc = np.asarray(jax.vmap(ref_acq.local_candidates_dev,
                                  in_axes=(0, 0, 0, None))(
        ref_p, jnp.asarray(inc), jnp.asarray(has), fill))
    got = port_acq.local_candidates_dev(port_p, torch.as_tensor(inc),
                                        torch.as_tensor(has),
                                        torch.as_tensor(grid[0]))
    _close(got.numpy(), ref_loc)
    bnd = np.stack([
        ref_acq.assemble_candidates(pb, grid, None, True,
                                    l_pad=surfaces["l_pad"])[len(grid):
                                                             len(grid)
                                                             + surfaces[
                                                                 "l_pad"]]
        for pb in surfaces["ref_pbs"]]).astype(np.float32)
    ref_c = np.asarray(jax.vmap(ref_acq.assemble_candidates_dev,
                                in_axes=(0, None, 0, 0, 0, None))(
        ref_p, jnp.asarray(grid), jnp.asarray(bnd), jnp.asarray(inc),
        jnp.asarray(has), True))
    got_c = port_acq.assemble_candidates_dev(
        port_p, torch.as_tensor(grid), torch.as_tensor(bnd),
        torch.as_tensor(inc), torch.as_tensor(has), True)
    _close(got_c.numpy(), ref_c)
    off = port_acq.assemble_candidates_dev(
        port_p, torch.as_tensor(grid), torch.as_tensor(bnd),
        torch.as_tensor(inc), torch.as_tensor(has), False)
    assert off.shape == got_c.shape
    assert torch.equal(off[:, -port_acq.N_LOCAL:],
                       torch.as_tensor(grid[0]).expand(3, 45, 2))
