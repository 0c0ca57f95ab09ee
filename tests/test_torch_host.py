"""The port's copied host layer (configs, channel, cost model, profiles,
problem) equals the reference exactly: same float64 numbers, same
integers, for VGG19, ResNet101 and every request architecture.
Tolerance: none (bitwise equality)."""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.configs import cnn as ref_cnn
from repro.core import batch_bo as ref_batch
from repro.core import problem as ref_problem
from repro.wireless import channel as ref_channel
from repro_torch import configs as port_configs
from repro_torch.configs import cnn as port_cnn
from repro_torch.core import batch_bo as port_batch
from repro_torch.core import problem as port_problem
from repro_torch.wireless import channel as port_channel

ARCHS = ref_batch.request_archs()


def test_request_archs_equal():
    assert port_batch.request_archs() == ARCHS
    assert len(ARCHS) == 12


@pytest.mark.parametrize("name", ref_configs.list_configs())
def test_model_configs_equal(name):
    ref = dataclasses.asdict(ref_configs.get_config(name))
    port = dataclasses.asdict(port_configs.get_config(name))
    assert ref == port
    assert (port_configs.get_config(name).layer_kinds()
            == ref_configs.get_config(name).layer_kinds())


@pytest.mark.parametrize("name", ["vgg19-imagenet-mini",
                                  "resnet101-tiny-imagenet"])
def test_cnn_configs_equal(name):
    ref = ref_cnn.get_cnn_config(name)
    port = port_cnn.get_cnn_config(name)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert ref.cumulative_macs() == port.cumulative_macs()


def test_channel_equal():
    p = np.linspace(0.0, 1.0, 17)
    g = np.linspace(-120.0, -60.0, 17)
    link = port_channel.LinkParams()
    assert link.noise_power_w == ref_channel.LinkParams().noise_power_w
    np.testing.assert_array_equal(port_channel.achievable_rate(p, g),
                                  ref_channel.achievable_rate(p, g))
    np.testing.assert_array_equal(port_channel.tx_delay_s(8e6, p, g),
                                  ref_channel.tx_delay_s(8e6, p, g))
    np.testing.assert_array_equal(
        port_channel.required_power_w(8e6, 2.0, g),
        ref_channel.required_power_w(8e6, 2.0, g))


def _problems(arch, gain_offset_db=0.0):
    return (ref_batch.scenario_from_request(arch, gain_offset_db).problem,
            port_batch.scenario_from_request(arch, gain_offset_db).problem)


def _grid(n=13):
    xs = np.linspace(0.0, 1.0, n)
    return np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_budgets_and_bounds_equal(arch):
    ref, port = _problems(arch, gain_offset_db=-1.5)
    rp, pp = ref.cm.profile, port.cm.profile
    assert (rp.name, rp.n_layers, rp.total_macs) == (pp.name, pp.n_layers,
                                                     pp.total_macs)
    np.testing.assert_array_equal(rp.cum_macs, pp.cum_macs)
    np.testing.assert_array_equal(rp.tx_bytes, pp.tx_bytes)
    assert dataclasses.asdict(ref.cm.budgets) == dataclasses.asdict(
        port.cm.budgets)
    assert dataclasses.asdict(ref.util) == dataclasses.asdict(port.util)
    assert ref.gain_db == port.gain_db
    # the decoded request keeps the base problem's power bounds
    assert (ref.p_min, ref.p_max) == (port.p_min, port.p_max)
    base = port_batch._base_request_problem(arch)
    assert (port.p_min, port.p_max) == (base.p_min, base.p_max)
    np.testing.assert_array_equal(ref.boundary_candidates(),
                                  port.boundary_candidates())


@pytest.mark.parametrize("arch", ARCHS)
def test_evaluate_on_grid_equal(arch):
    ref, port = _problems(arch)
    for a in _grid():
        assert ref.denormalize(a) == port.denormalize(a)
        assert ref.constraint_values(a) == port.constraint_values(a)
        assert ref.penalty(a) == port.penalty(a)
        assert ref._accuracy(*ref.denormalize(a)) == port._accuracy(
            *port.denormalize(a))
        np.testing.assert_array_equal(ref.project_feasible(a),
                                      port.project_feasible(a))
        assert ref.evaluate(a) == port.evaluate(a)
        l, p = port.denormalize(a)
        np.testing.assert_array_equal(ref.normalize(l, p),
                                      port.normalize(l, p))
    np.testing.assert_array_equal(ref.penalty_batch(_grid()),
                                  port.penalty_batch(_grid()))
    assert ([dataclasses.astuple(dataclasses.replace(h, a=None))
             for h in ref.history]
            == [dataclasses.astuple(dataclasses.replace(h, a=None))
                for h in port.history])


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a not in ("vgg19", "resnet101")])
def test_derive_lm_budgets_equal(arch):
    ref_cfg = ref_configs.get_config(arch)
    port_cfg = port_configs.get_config(arch)
    from repro.core.cost_model import CostModel as RefCM
    from repro.core.profiles import lm_profile as ref_lm
    from repro_torch.core.cost_model import CostModel as PortCM
    from repro_torch.core.profiles import lm_profile as port_lm
    for seq in (64, 128):
        rb = ref_problem.derive_lm_budgets(RefCM(ref_lm(ref_cfg, seq)))
        pb = port_problem.derive_lm_budgets(PortCM(port_lm(port_cfg, seq)))
        assert dataclasses.asdict(rb) == dataclasses.asdict(pb)


def test_default_problems_and_optimum_equal():
    for name in ("default_vgg19_problem", "default_resnet101_problem"):
        ref = getattr(ref_problem, name)()
        port = getattr(port_problem, name)()
        assert ref.gain_db == port.gain_db
        ra, ru = ref.exhaustive_optimum(n_power=101)
        pa, pu = port.exhaustive_optimum(n_power=101)
        np.testing.assert_array_equal(ra, pa)
        assert ru == pu


def test_padded_profiles_equal():
    from repro.core.profiles import padded_profiles as ref_pad
    from repro_torch.core.profiles import padded_profiles as port_pad
    ref = [ref_problem.default_vgg19_problem().cm.profile,
           ref_problem.default_resnet101_problem().cm.profile]
    port = [port_problem.default_vgg19_problem().cm.profile,
            port_problem.default_resnet101_problem().cm.profile]
    for (rp, rv), (pp, pv) in zip(ref_pad(ref), port_pad(port)):
        np.testing.assert_array_equal(rv, pv)
        np.testing.assert_array_equal(rp.cum_macs, pp.cum_macs)
        np.testing.assert_array_equal(rp.tx_bytes, pp.tx_bytes)
        assert rp.n_layers == pp.n_layers
