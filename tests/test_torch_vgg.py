"""The port's VGG19 (``repro_torch.models.vgg``) against the reference's
(``repro.models.vgg``): the reference's weights
(``init_vgg19(PRNGKey(0), n_classes=10)``) carried across by
``interop.vgg19_from_reference`` and one seeded 1 x 224 x 224 x 3 image
go through both, and the logits agree at the reference's own tolerance
(atol = rtol = 1e-3, ``tests/test_vgg_profiles.py``). The boundary
payload's bytes equal the analytic profile's at every split, the
classifier flattens in the reference's NHWC order, and ``make_executor``
runs one partitioned forward an evaluation of a CPU Bayes-Split-Edge run
without changing its answers."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.cnn import get_cnn_config as ref_cnn_config
from repro.models import vgg as ref_vgg
from repro_torch.configs.cnn import get_cnn_config
from repro_torch.core import BayesSplitEdge, default_vgg19_problem
from repro_torch.interop import vgg19_from_reference
from repro_torch.models import vgg

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
SPLITS = [0, 7, 19, 37]


@pytest.fixture(scope="module")
def both():
    """(reference params, image, port params, port image, reference
    logits of the unsplit forward)."""
    params = ref_vgg.init_vgg19(jax.random.PRNGKey(0), n_classes=10)
    img = jax.random.normal(jax.random.PRNGKey(1), (1, 224, 224, 3)) * 0.1
    logits = np.asarray(ref_vgg.vgg19_classifier(
        params, ref_vgg.vgg19_features(params, img)))
    port = vgg19_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    return params, img, port, torch.tensor(np.asarray(img)), logits


def test_plan_and_modules_are_the_reference_s():
    assert vgg.PLAN == ref_vgg.PLAN
    assert vgg.module_list() == ref_vgg.module_list()


def test_vgg19_from_reference_layout(both):
    params, _, port, _, _ = both
    assert len(port["convs"]) == len(params["convs"]) == 16
    for (w, b), (rw, rb) in zip(port["convs"], params["convs"]):
        rw = np.asarray(rw)
        assert tuple(w.shape) == (rw.shape[3], rw.shape[2], 3, 3)
        assert w.dtype == torch.float32 and w.is_contiguous()
        np.testing.assert_array_equal(w.numpy(), rw.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    for (w, b), (rw, rb) in zip(port["fcs"], params["fcs"]):
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(rb))


@pytest.mark.parametrize("l", SPLITS)
def test_features_match_the_reference(both, l):
    """Both halves of the features at split ``l``, each from the
    reference's own input, NHWC in and out."""
    params, img, port, timg, _ = both
    head = np.asarray(ref_vgg.vgg19_features(params, img, 0, l))
    got = vgg.vgg19_features(port, timg, 0, l)
    assert tuple(got.shape) == head.shape
    np.testing.assert_allclose(got.numpy(), head, **TOL)
    tail = np.asarray(ref_vgg.vgg19_features(params, head, l, 37))
    got = vgg.vgg19_features(port, torch.tensor(head), l, 37)
    np.testing.assert_allclose(got.numpy(), tail, **TOL)


@pytest.mark.parametrize("l", SPLITS)
def test_split_forward_matches_the_reference(both, l):
    params, img, port, timg, logits = both
    got, nbytes = vgg.split_forward(port, timg, l)
    ref_logits, ref_bytes = ref_vgg.split_forward(params, img, l)
    np.testing.assert_allclose(got.numpy(), logits, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_logits), **TOL)
    assert nbytes == ref_bytes == int(
        get_cnn_config("vgg19-imagenet-mini").activation_bytes(l))


def test_unsplit_forward_matches_the_reference(both):
    _, _, port, timg, logits = both
    got = vgg.vgg19_classifier(port, vgg.vgg19_features(port, timg))
    np.testing.assert_allclose(got.numpy(), logits, **TOL)
    for l in SPLITS:                # the hop changes no bit on the CPU
        assert torch.equal(vgg.split_forward(port, timg, l)[0], got)


def test_boundary_bytes_at_every_split_from_one_pass(both):
    """One pass through the 37 modules: the NHWC activation entering
    module l has the profile's ``activation_bytes(l)`` in both packages'
    configs, and the hop carries exactly those bytes."""
    _, _, port, timg, _ = both
    prof, ref_prof = (get_cnn_config("vgg19-imagenet-mini"),
                      ref_cnn_config("vgg19-imagenet-mini"))
    x = timg
    for l in range(38):
        want = int(prof.activation_bytes(l))
        assert want == int(ref_prof.activation_bytes(l))
        received, nbytes = vgg.wireless_hop(x)
        assert nbytes == x.numel() * x.element_size() == want, l
        assert torch.equal(received, x)
        if l < 37:
            x = vgg.vgg19_features(port, x, l, l + 1)
    assert tuple(x.shape) == (1, 7, 7, 512)


def test_classifier_flattens_nhwc_like_the_reference(both):
    """The flatten-order trap: on features that are not symmetric in
    their axes, the port's classifier matches the reference's, and an
    NCHW flatten of the same features gives other logits by far more
    than the tolerance."""
    params, _, port, _, _ = both
    feats = np.random.default_rng(0).standard_normal(
        (1, 7, 7, 512)).astype(np.float32)
    want = np.asarray(ref_vgg.vgg19_classifier(params, feats))
    tf = torch.tensor(feats)
    got = vgg.vgg19_classifier(port, tf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    nchw = tf.permute(0, 3, 1, 2).reshape(1, -1)
    for i, (w, b) in enumerate(port["fcs"]):
        nchw = nchw @ w + b
        nchw = torch.relu(nchw) if i < 2 else nchw
    assert np.abs(nchw.numpy() - want).max() > 100 * TOL["atol"]


def test_init_vgg19_draws_at_the_reference_scales():
    a = vgg.init_vgg19(torch.Generator().manual_seed(3), n_classes=10,
                       device="cpu")
    b = vgg.init_vgg19(torch.Generator().manual_seed(3), n_classes=10,
                       device="cpu")
    ref = jax.eval_shape(lambda: ref_vgg.init_vgg19(jax.random.PRNGKey(0),
                                                    n_classes=10))
    cin = 3
    for (w, bias), (w2, _), (rw, rb) in zip(a["convs"], b["convs"],
                                            ref["convs"]):
        assert torch.equal(w, w2)
        kh, kw, ci, co = rw.shape
        assert tuple(w.shape) == (co, ci, kh, kw) and ci == cin
        assert float(w.std()) == pytest.approx(math.sqrt(2 / (9 * cin)),
                                               rel=0.05)
        assert not bias.any() and tuple(bias.shape) == rb.shape
        cin = co
    for (w, bias), (rw, rb) in zip(a["fcs"], ref["fcs"]):
        assert tuple(w.shape) == rw.shape and tuple(bias.shape) == rb.shape
        assert float(w.std()) == pytest.approx(math.sqrt(1 / rw.shape[0]),
                                               rel=0.05)
        assert not bias.any()


def test_make_executor_runs_the_split_forward_each_evaluation(both,
                                                              monkeypatch):
    """A recording executor around ``make_executor``'s, in a CPU
    Bayes-Split-Edge run: one call and one partitioned forward an
    evaluation, at the ledger's (l, p), and the run's answers those of
    the run without an executor."""
    _, _, port, timg, _ = both
    forwards = []
    split_forward = vgg.split_forward

    def counted(params, images, l):
        forwards.append(l)
        return split_forward(params, images, l)

    monkeypatch.setattr(vgg, "split_forward", counted)
    run_real = vgg.make_executor(port, timg)
    calls = []

    def recording(l, p_w):
        calls.append((l, p_w))
        run_real(l, p_w)

    pb = default_vgg19_problem(executor=recording)
    res = BayesSplitEdge(pb, budget=20, device="cpu").run(seed=0)
    plain_pb = default_vgg19_problem()
    plain = BayesSplitEdge(plain_pb, budget=20, device="cpu").run(seed=0)
    assert calls == [(h.l, h.p_w) for h in pb.history]
    assert len(calls) == res.n_evals == 20
    assert forwards == [l for l, _ in calls]
    assert res.accuracies == plain.accuracies
    assert res.utilities == plain.utilities
    assert res.incumbent_trace == plain.incumbent_trace
    np.testing.assert_array_equal(res.best_a, plain.best_a)
    assert [(h.l, h.p_w) for h in plain_pb.history] == calls
