"""The port's checkpoint layer (``checkpoint/ckpt.py``) against the
reference's: the same ``step_<N>/{manifest.json, arrays.npz,
COMMITTED}`` layout and flat keys, so a checkpoint written by either
package loads in the other; mixed-dtype round trips, manifest metadata,
retries of transient write failures and the give-up path without a torn
commit (as ``tests/test_checkpoint.py``), and the manager's interval,
retention, async writes and restore onto a device."""
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_flat, load_manifest, load_named,
                                    restore, save, unflatten)


def _pool_tree(lib="port"):
    """A serving-shaped tree: device state of mixed dtypes beside numpy
    lane maps (int64) and Python scalars, two pools deep, plus a list
    and a tuple."""
    if lib == "port":
        def arr(v, dtype):
            return torch.as_tensor(np.asarray(v), dtype=dtype)
        f32, i32, b = torch.float32, torch.int32, torch.bool
    else:
        def arr(v, dtype):
            return jnp.asarray(np.asarray(v), dtype)
        f32, i32, b = jnp.float32, jnp.int32, bool
    return {
        "pools": {
            "0": {
                "order": np.array([3, -1, 5, 0], np.int64),
                "it": 7,
                "state": {
                    "x": arr(np.full((4, 16, 2), 0.25), f32),
                    "n": arr([3, 0, 5, 9], i32),
                    "active": arr([True, False, True, True], b),
                    "theta": {"log_ls": arr([-1.2, -0.5, 0.0, 1.0], f32)},
                },
            },
            "10": {"order": np.array([-1, -1], np.int64), "it": 0},
        },
        "queue": [np.array([7, 8], np.int64), (2.5, np.float64(1.0))],
    }


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = _host(a[k]), _host(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_flat_roundtrip_mixed_dtypes(tmp_path):
    t = _pool_tree()
    save(str(tmp_path), 3, t, metadata=dict(stream=dict(n_shards=2)))
    tree = unflatten(load_flat(str(tmp_path), 3))
    st = tree["pools"]["0"]["state"]
    assert st["x"].dtype == np.float32 and st["n"].dtype == np.int32
    assert st["active"].dtype == np.bool_
    np.testing.assert_array_equal(st["theta"]["log_ls"],
                                  t["pools"]["0"]["state"]["theta"]
                                  ["log_ls"].numpy())
    assert int(tree["pools"]["0"]["it"]) == 7
    np.testing.assert_array_equal(tree["queue"]["0"], [7, 8])
    assert float(tree["queue"]["1"]["0"]) == 2.5
    man = load_manifest(str(tmp_path), 3)
    assert man["metadata"]["stream"] == dict(n_shards=2)
    assert man["keys"]["pools/0/state/x"] == dict(shape=[4, 16, 2],
                                                  dtype="float32")
    assert man["process_index"] == 0 and man["process_count"] == 1


def test_flat_keys_and_arrays_equal_reference(tmp_path):
    """The same tree saved by both packages: the same keys, in the same
    (sorted) manifest order, and the same bytes."""
    save(str(tmp_path / "port"), 1, _pool_tree("port"))
    ref.save(str(tmp_path / "ref"), 1, _pool_tree("ref"))
    mp = load_manifest(str(tmp_path / "port"), 1)
    mr = ref.load_manifest(str(tmp_path / "ref"), 1)
    assert list(mp["keys"]) == list(mr["keys"])
    assert mp["keys"] == mr["keys"]
    _flat_equal(load_flat(str(tmp_path / "port"), 1),
                ref.load_flat(str(tmp_path / "ref"), 1))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    """A checkpoint restores in the other package as that package's own
    checkpoint of the same tree does (JAX restores int64 as int32)."""
    d, own = str(tmp_path / "other"), str(tmp_path / "own")
    if writer == "port":
        save(d, 4, _pool_tree("port"), metadata=dict(kind="snap"))
        ref.save(own, 4, _pool_tree("ref"))
        got = ref.restore(d, ref.latest_step(d), _pool_tree("ref"))
        want = ref.restore(own, 4, _pool_tree("ref"))
        _, named, meta = ref.load_named(d, "snap")
    else:
        ref.save(d, 4, _pool_tree("ref"), metadata=dict(kind="snap"))
        save(own, 4, _pool_tree("port"))
        got = restore(d, latest_step(d), _pool_tree("port"), device="cpu")
        want = restore(own, 4, _pool_tree("port"), device="cpu")
        _, named, meta = load_named(d, "snap")
    assert meta == dict(kind="snap")
    _flat_equal(ref._flatten(got), ref._flatten(want))
    assert named["pools"]["10"]["order"].tolist() == [-1, -1]


def test_restore_puts_tensors_on_the_device(tmp_path):
    t = _pool_tree()
    save(str(tmp_path), 2, t)
    back = restore(str(tmp_path), 2, t, device="cpu")
    st = back["pools"]["0"]["state"]
    assert isinstance(st["x"], torch.Tensor) and st["x"].dtype == \
        torch.float32
    assert torch.equal(st["n"], t["pools"]["0"]["state"]["n"])
    assert isinstance(back["queue"], list) and isinstance(back["queue"][1],
                                                          tuple)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            restore(str(tmp_path), 2, t)


def test_save_retries_transient_oserror(tmp_path, monkeypatch):
    """A flaky disk that fails the first two write attempts must not
    lose the snapshot: the third attempt commits normally."""
    fails = {"left": 2}
    real_savez = np.savez

    def flaky_savez(path, **kw):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise OSError("injected transient I/O failure")
        return real_savez(path, **kw)

    monkeypatch.setattr("repro_torch.checkpoint.ckpt.np.savez", flaky_savez)
    save(str(tmp_path), 4, _pool_tree(), retries=3, retry_backoff_s=0.001)
    assert fails["left"] == 0
    assert latest_step(str(tmp_path)) == 4
    np.testing.assert_array_equal(
        unflatten(load_flat(str(tmp_path), 4))["pools"]["0"]["order"],
        _pool_tree()["pools"]["0"]["order"])


def test_save_gives_up_with_warning_no_torn_manifest(tmp_path, monkeypatch):
    """Persistent I/O failure: a warning, not an exception, no partial
    commit left behind, and the previous commit still the latest."""
    save(str(tmp_path), 3, _pool_tree())

    def always_fail(path, **kw):
        raise OSError("injected permanent I/O failure")

    monkeypatch.setattr("repro_torch.checkpoint.ckpt.np.savez", always_fail)
    with pytest.warns(RuntimeWarning, match="gave up after 2 attempts"):
        save(str(tmp_path), 7, _pool_tree(), retries=2,
             retry_backoff_s=0.001)
    assert latest_step(str(tmp_path)) == 3
    assert not os.path.exists(str(tmp_path / "step_00000007"))
    assert not os.path.exists(str(tmp_path / "step_00000007.tmp"))
    assert load_manifest(str(tmp_path), 3)["step"] == 3


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_interval_retention_and_restore(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), save_interval=2, keep=2,
                            async_save=async_save)
    t = _pool_tree()
    saved = [mgr.maybe_save(s, t) for s in range(1, 8)]
    mgr.wait()
    assert saved == [False, True, False, True, False, True, False]
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000006"]
    step, back = mgr.restore_latest(t, device="cpu")
    assert step == 6
    assert torch.equal(back["pools"]["0"]["state"]["x"],
                       t["pools"]["0"]["state"]["x"])
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(t, device="cpu") == (None, None)


def test_sigterm_force_save(tmp_path):
    """The preemption path: a SIGTERM handler force-saves regardless of
    the interval, and the commit is immediately loadable."""
    mgr = CheckpointManager(str(tmp_path), save_interval=1000, keep=2,
                            async_save=False)
    saved = {}

    def on_sigterm(signum, frame):
        saved["ok"] = mgr.maybe_save(17, _pool_tree(),
                                     metadata=dict(reason="sigterm"),
                                     force=True)

    old = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert saved["ok"] is True
    assert latest_step(str(tmp_path)) == 17
    assert load_manifest(str(tmp_path), 17)["metadata"]["reason"] == \
        "sigterm"
