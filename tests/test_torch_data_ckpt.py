"""The port's data pipeline and checkpointer against the JAX package's, on
the CPU.

* ``batch_at``: the reference draws its tokens with ``jax.random`` under
  x64 (threefry2x32, ``fold_in`` of the step and the host, 64 random bits
  a value made an f64 uniform); the port keeps its own threefry2x32 in
  numpy and must give the same tokens bit for bit — on the shapes
  (vocab, seq, batch, step) (1000, 16, 8, 7), (152064, 128, 8, 3),
  (256000, 512, 4, 11) and (152064, 512, 8, 0), and with 2 hosts, each
  host's slice. Its f64 uniforms equal ``jax.random.uniform``'s bit for
  bit.
* Checkpoints: a train state the reference saved (its params, optimizer
  state in the f32 or 8-bit mode, and error-feedback state) restores into
  the port's train state with every array equal, and a state the port
  saved restores into the reference's; both packages name the arrays the
  same. The reference's own tests of the pipeline and the checkpointer
  (``tests/test_system.py``), mirrored on the port; the atomic publish
  and the disk-space refusal.
"""
import _torch_test_setup  # noqa: F401  (before any reference compile)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpointing as jck
from repro.data import pipeline as jpipe
from repro.models import transformer as JT
from repro.optim import grad_compress as jgc
from repro.optim import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpointing as tck
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizer as topt

SHAPES = [(1000, 16, 8, 7, 1, 0), (152064, 128, 8, 3, 1, 0),
          (256000, 512, 4, 11, 1, 0), (152064, 512, 8, 0, 1, 0),
          (1000, 16, 8, 7, 2, 0), (1000, 16, 8, 7, 2, 1)]


@pytest.mark.parametrize("vocab,seq,batch,step,n_hosts,host", SHAPES)
def test_batch_at_bitwise_the_reference(vocab, seq, batch, step, n_hosts,
                                        host):
    kw = dict(vocab=vocab, seq=seq, global_batch=batch, n_hosts=n_hosts,
              host_id=host)
    want = jpipe.batch_at(jpipe.DataConfig(**kw), step)
    got = tpipe.batch_at(tpipe.DataConfig(**kw), step)
    for k in ("tokens", "targets"):
        a = np.asarray(want[k])
        assert got[k].dtype == torch.int32
        assert a.shape == tuple(got[k].shape) == (batch // n_hosts, seq)
        assert np.array_equal(a, got[k].numpy()), k


def test_uniforms_and_keys_bitwise_jax_random():
    for seed, step, host in ((0, 0, 0), (3, 11, 1), (2 ** 33 + 5, 7, 0)):
        jkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), step), host)
        key = tpipe.fold_in(tpipe.fold_in(tpipe.prng_key(seed), step), host)
        assert np.array_equal(np.asarray(jax.random.key_data(jkey)
                                         if jkey.dtype != jnp.uint32
                                         else jkey), key)
        for n in (1, 7, 1000):
            want = np.asarray(jax.random.uniform(
                jkey, (n,), jnp.float64, minval=1e-6, maxval=1.0))
            got = tpipe.uniform_f64(key, n)
            assert np.array_equal(want.view(np.uint64), got.view(np.uint64))


def test_data_pipeline_deterministic_and_host_sharded():
    dc = tpipe.DataConfig(vocab=1000, seq=16, global_batch=8, n_hosts=2,
                          host_id=0)
    b1, b2 = tpipe.batch_at(dc, 7), tpipe.batch_at(dc, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = tpipe.batch_at(dataclasses.replace(dc, host_id=1), 7)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert tuple(b1["tokens"].shape) == (4, 16)
    assert int(b1["tokens"].max()) < 1000
    assert torch.equal(b1["targets"][:, :-1], b1["tokens"][:, 1:])
    st = tpipe.stream(dc, start_step=6)
    next(st)
    assert torch.equal(next(st)["tokens"], b1["tokens"])


def ref_state(mode: str):
    """A reference train state after one AdamW step on a zero gradient
    plus noise, as the reference's ``build_train_step`` lays it out."""
    cfg = dataclasses.replace(jconfigs.get("qwen2_7b").SMOKE, n_layers=2)
    ocfg = jopt.AdamWConfig(quantized_moments=mode == "8bit")
    p = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(1)
    g = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)), p)
    ef = None
    if mode == "ef":
        g, ef = jgc.compress_tree(g, jgc.init_ef(p))
    p, s = jopt.update(p, g, jopt.init(p, ocfg), ocfg)
    return {"params": p, "opt": s, "ef": ef}


def port_template(mode: str):
    cfg = dataclasses.replace(tconfigs.get("qwen2_7b").SMOKE, n_layers=2)
    tc = ttrain.TrainConfig(grad_compression=mode == "ef",
                            quantized_moments=mode == "8bit")
    return ttrain.state_template(
        cfg, tc, topt.AdamWConfig(quantized_moments=mode == "8bit"))


MODES = ["f32", "8bit", "ef"]


@pytest.mark.parametrize("mode", MODES)
def test_reference_checkpoint_restores_into_the_port(tmp_path, mode):
    state = ref_state(mode)
    jck.Checkpointer(str(tmp_path)).save(4, state)
    got, manifest = tck.Checkpointer(str(tmp_path)).restore(
        port_template(mode), device="cpu")
    assert manifest["step"] == 4
    want = jck._flatten(state)
    flat = dict(tck._items(got))
    assert sorted(flat) == sorted(want)
    for k, a in want.items():
        assert flat[k].numpy().dtype == a.dtype, k
        assert np.array_equal(flat[k].numpy(), a), k
    assert isinstance(got["opt"], topt.OptState)
    assert (got["ef"] is None) == (mode != "ef")


@pytest.mark.parametrize("mode", MODES)
def test_port_checkpoint_restores_into_the_reference(tmp_path, mode):
    jstate = ref_state(mode)
    template = jax.tree_util.tree_map(np.asarray, jstate)
    # the port's own state: the reference's carried across, then saved
    jck.Checkpointer(str(tmp_path / "a")).save(1, jstate)
    port, _ = tck.Checkpointer(str(tmp_path / "a")).restore(
        port_template(mode), device="cpu")
    tck.Checkpointer(str(tmp_path / "b")).save(2, port)
    got, manifest = jck.Checkpointer(str(tmp_path / "b")).restore(template)
    assert manifest["step"] == 2
    for k, a in jck._flatten(template).items():
        assert np.array_equal(jck._flatten(got)[k], a), k
    assert sorted(jck._flatten(got)) == sorted(dict(tck._items(port)))


def test_checkpoint_save_restore_atomic(tmp_path):
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    state = {"w": torch.arange(8.0), "opt": {"m": torch.ones(3, 3)},
             "step": torch.tensor(5)}
    ck.save(5, state)
    ck.save(10, state, blocking=False)
    ck.wait()
    ck.save(15, state)
    assert ck.all_steps() == [10, 15]  # keep=2 gc'd step 5
    restored, manifest = ck.restore(state)
    assert manifest["step"] == 15
    assert torch.equal(restored["w"], torch.arange(8.0))
    assert [e["step"] for e in ck.stats] == [5, 10, 15]
    assert all(e["write_s"] >= 0 and e["bytes"] == 8 * 4 + 9 * 4 + 8
               for e in ck.stats)
    # a half-written snapshot is never taken for a checkpoint
    (tmp_path / "step_00000020.tmp").mkdir()
    assert ck.latest_step() == 15


def test_save_copies_before_it_returns(tmp_path):
    """The host copy is made before ``save`` returns, so an in-place update
    right after an asynchronous save cannot reach the snapshot."""
    ck = tck.Checkpointer(str(tmp_path))
    state = {"w": torch.zeros(1000)}
    ck.save(1, state, blocking=False)
    state["w"].add_(1.0)
    ck.wait()
    restored, _ = ck.restore(state)
    assert float(restored["w"].abs().max()) == 0.0


def test_save_refuses_without_room(tmp_path, monkeypatch):
    ck = tck.Checkpointer(str(tmp_path))
    monkeypatch.setattr(tck.shutil, "disk_usage",
                        lambda path: type("U", (), {"free": 10})())
    with pytest.raises(OSError, match="needs 4,000 bytes"):
        ck.save(1, {"w": torch.zeros(1000)})
    assert ck.all_steps() == []


def test_restore_onto_a_device_from_a_meta_template(tmp_path):
    """The reference's elastic restore places arrays with new shardings;
    on one device the port places them on ``device`` from a template that
    holds no memory."""
    ck = tck.Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(16.0).reshape(4, 4)})
    restored, _ = ck.restore({"w": torch.empty(4, 4, device="meta")},
                             device="cpu")
    assert torch.equal(restored["w"], torch.arange(16.0).reshape(4, 4))
    with pytest.raises(FileNotFoundError):
        tck.Checkpointer(str(tmp_path / "none")).restore({})


def test_same_step_saved_again_replaces_it(tmp_path):
    ck = tck.Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.zeros(4)})
    ck.save(3, {"w": torch.ones(4)}, blocking=False)
    ck.wait()
    assert ck.all_steps() == [3]
    assert torch.equal(ck.restore({"w": torch.zeros(4)})[0]["w"],
                       torch.ones(4))


def test_a_failed_background_write_raises_on_wait(tmp_path, monkeypatch):
    ck = tck.Checkpointer(str(tmp_path))

    def full(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez", full)
    ck.save(1, {"w": torch.zeros(4)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.all_steps() == []
    ck.wait()                           # reported once


def test_reader_reads_numpys_archive_and_refuses_what_it_never_writes(
        tmp_path):
    """The reader takes ``np.savez``'s archive (0-d and empty arrays among
    its members) bit for bit, and refuses a compressed member and a
    Fortran-order one rather than misreading them."""
    rng = np.random.RandomState(2)
    flat = {"a/.m/x": rng.randn(3, 5).astype(np.float32),
            "s": np.asarray(7, np.int32), "q": np.zeros((0, 4), np.int8),
            "v": rng.randint(-127, 128, 9).astype(np.int8)}
    np.savez(tmp_path / "p.npz", **flat)
    reader = tck._StoredNpz(str(tmp_path / "p.npz"))
    for k, a in flat.items():
        got = reader[k]
        assert got.dtype == a.dtype and got.shape == a.shape
        assert np.array_equal(got, a), k
        assert torch.equal(reader.tensor(k, "cpu"), torch.from_numpy(a))
    reader.close()
    np.savez_compressed(tmp_path / "c.npz", x=flat["a/.m/x"])
    np.savez(tmp_path / "f.npz", x=np.asfortranarray(rng.randn(4, 3)))
    for name, what in (("c.npz", "compressed"), ("f.npz", "Fortran")):
        reader = tck._StoredNpz(str(tmp_path / name))
        with pytest.raises(ValueError, match=what):
            reader["x"]
        reader.close()
