"""The port's training infrastructure on the CPU: the data pipeline, the
checkpoints, the Trainer, the launcher and the rest of Algorithm 1
(``tree_target_block_sizes``, ``saturated_mask``, ``hetero_batch_split``).

Host NumPy code is held bit-equal to the JAX package on the same inputs:
``SyntheticLM``'s batches, the three Algorithm 1 helpers and the
Trainer's batch shares.  ``tests/test_train_infra.py``'s checkpoint,
data and trainer cases run on the port as they run on the reference.
"""
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.core import block_sizes as jbs
from repro.core import topology as jtopo
from repro.data import pipeline as jdata
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_config
from repro_torch.core import block_sizes as tbs
from repro_torch.core import topology as ttopo
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.train.checkpoint import (latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = "cpu"


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,rank,world", [
    (0, 0, 0, 1), (3, 5, 0, 1), (3, 5, 1, 2), (7, 123, 3, 4),
    (1, 2, 0, 8)])
def test_synthetic_lm_bit_equal(seed, step, rank, world):
    kw = dict(vocab=1000, seq_len=48, global_batch=8, seed=seed)
    got = SyntheticLM(DataConfig(**kw)).batch(step, rank, world)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step, rank,
                                                           world)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=3)
    a = SyntheticLM(cfg).batch(5)
    b = SyntheticLM(cfg).batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_labels_shifted():
    b = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=4)
                    ).batch(0)
    assert b["tokens"].shape == (4, 16)
    assert np.all(b["labels"] < 100) and np.all(b["tokens"] >= 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_rank_disjoint():
    d = SyntheticLM(DataConfig(vocab=100, seq_len=16, global_batch=8))
    r0 = d.batch(0, rank=0, world=2)
    r1 = d.batch(0, rank=1, world=2)
    assert r0["tokens"].shape == (4, 16)
    assert not np.array_equal(r0["tokens"], r1["tokens"])


# -- checkpoint -------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6, dtype=torch.float32
                                          ).reshape(2, 3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(tmp_path, state, step=7)
    path = latest_checkpoint(tmp_path)
    assert path is not None and path.name == "step_00000007"
    like = {"params": {"w": torch.zeros(2, 3)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    restored, manifest = restore_checkpoint(path, like)
    assert manifest["step"] == 7
    assert restored is like
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["opt"]["step"]) == 7


def test_checkpoint_gc(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, state, step=s, keep=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000004", "step_00000005"]


def test_checkpoint_shape_mismatch(tmp_path):
    save_checkpoint(tmp_path, {"w": torch.zeros(3)}, step=1)
    with pytest.raises(ValueError):
        restore_checkpoint(latest_checkpoint(tmp_path),
                           {"w": torch.zeros(4)})
    with pytest.raises(KeyError):
        restore_checkpoint(latest_checkpoint(tmp_path),
                           {"v": torch.zeros(3)})


def test_checkpoint_bf16_bit_for_bit(tmp_path):
    """bf16 is stored as a uint16 view and restored bit for bit, NaN and
    Inf patterns, subnormals and negative zero included."""
    bits = torch.from_numpy(np.random.default_rng(0).integers(
        -2 ** 15, 2 ** 15, size=4096, dtype=np.int16))
    special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                            -0.0, 1e-40], dtype=torch.bfloat16)
    w = torch.cat([bits.view(torch.bfloat16), special])
    model = torch.nn.Linear(8, 4, dtype=torch.bfloat16)
    state = {"params": model, "opt": {"w": w}}
    path = save_checkpoint(tmp_path, state, step=3)
    data = np.load(path / "state.npz")
    assert data["opt/w"].dtype == np.uint16
    assert set(data.files) == {"params/weight", "params/bias", "opt/w"}
    like = {"params": torch.nn.Linear(8, 4, dtype=torch.bfloat16),
            "opt": {"w": torch.zeros_like(w)}}
    restore_checkpoint(path, like)
    assert torch.equal(like["opt"]["w"].view(torch.int16),
                       w.view(torch.int16))
    for a, b in zip(like["params"].parameters(), model.parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# -- trainer ---------------------------------------------------------------------

def _state_bits(state) -> dict:
    from repro_torch.train.checkpoint import flatten_state
    return {k: t.detach().clone() for k, t in flatten_state(state).items()}


def test_trainer_fault_and_resume(tmp_path):
    """A fault at step 25, then a restart that resumes from step 20's
    checkpoint, bit for bit, and runs to 30."""
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    kw = dict(steps=30, seq_len=32, global_batch=4, ckpt_every=10,
              ckpt_dir=str(tmp_path), log_every=1000)
    tr = Trainer(cfg, TrainerConfig(**kw, fail_at_step=25), device=CPU)
    saved = {}
    with pytest.raises(RuntimeError, match="injected fault"):
        tr.run(on_metrics=lambda step, m: saved.update(
            {step: _state_bits(tr.state)}) if step == 20 else None)
    tr2 = Trainer(cfg, TrainerConfig(**kw), device=CPU)
    assert tr2.maybe_resume()
    assert tr2.step == 20
    got = _state_bits(tr2.state)
    assert set(got) == set(saved[20])
    assert {k.split("/")[0] for k in got} == {"params", "opt"}
    assert "opt/step" in got and int(got["opt/step"]) == 20
    for k, t in saved[20].items():
        assert torch.equal(got[k], t), k
    assert all(p.requires_grad for p in tr2.state["params"].parameters())
    losses = tr2.run()
    assert tr2.step == 30
    assert np.isfinite(losses).all()


def test_trainer_loss_decreases(tmp_path):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    tcfg = TrainerConfig(steps=40, seq_len=32, global_batch=8,
                         ckpt_every=1000, ckpt_dir=str(tmp_path),
                         log_every=1000, lr=3e-3)
    losses = Trainer(cfg, tcfg, device=CPU).run()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def _pair_topo(topo):
    return ttopo.Topology(tuple(ttopo.PU(p.speed, p.memory, p.name)
                                for p in topo.pus), topo.fanouts)


def test_trainer_elastic_rebalance(tmp_path):
    """The reference test's case; the shares before and after losing the
    two fast PUs equal the reference Trainer's."""
    jt = jtopo.Topology.topo1(8, 2 / 8, 4.0, 5.2)
    topo = _pair_topo(jt)
    cfg = get_config("mamba2-130m", smoke=True)
    tcfg = TrainerConfig(steps=1, seq_len=16, global_batch=64,
                         ckpt_dir=str(tmp_path), log_every=1000)
    tr = Trainer(cfg, tcfg, topo=topo, device=CPU)
    ref = jtrainer.Trainer(
        jget("mamba2-130m", smoke=True),
        jtrainer.TrainerConfig(steps=1, seq_len=16, global_batch=64,
                               ckpt_dir=str(tmp_path), log_every=1000),
        topo=jt)
    np.testing.assert_array_equal(tr.shares, ref.shares)
    assert tr.shares.dtype == ref.shares.dtype
    assert tr.shares.sum() == 64
    assert tr.shares[0] > tr.shares[-1]          # fast PU gets more
    shares = tr.rebalance(ttopo.Topology(topo.pus[2:]))
    np.testing.assert_array_equal(
        shares, ref.rebalance(jtopo.Topology(jt.pus[2:])))
    assert shares.sum() == 64
    assert len(shares) == 6
    assert shares.max() - shares.min() <= 1
    assert tr.measured_speeds_rebalance() is tr.shares


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-tiny"])
def test_trainer_batch_draws_match_reference(arch, tmp_path):
    """``_batch`` draws a VLM's ``img_embeds`` and the audio family's
    ``frames`` from ``default_rng(step)`` as the reference does, and a
    step of either family trains."""
    kw = dict(steps=1, seq_len=16, global_batch=2, ckpt_dir=str(tmp_path),
              log_every=1000)
    tr = Trainer(get_config(arch, smoke=True), TrainerConfig(**kw),
                 device=CPU)
    ref = jtrainer.Trainer(jget(arch, smoke=True),
                           jtrainer.TrainerConfig(**kw))
    got, want = tr._batch(3), ref._batch(3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert np.isfinite(tr.run()).all()


def test_launcher_trains_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--hetero", "0.25,4,5.2"]
    with pytest.raises(RuntimeError, match="injected fault"):
        tlaunch.main(argv + ["--fail-at-step", "3"])
    tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "Algorithm-1 batch shares" in out and "final loss" in out


def test_example_trains_on_the_cpu(tmp_path):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--smoke", "--steps", "3", "--seq", "16",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert latest_checkpoint(tmp_path).name == "step_00000003"


# -- the rest of Algorithm 1 --------------------------------------------------------

def _topos():
    """(name, reference topology, port topology, n, tree kwargs)."""
    out = []
    t = jtopo.scale_to_load(jtopo.Topology.topo1(8, 2 / 8, 2.0, 3.2), 1000)
    out.append(("topo1_fanouts_222", t, 1000.0, dict(fanouts=(2, 2, 2))))
    t = jtopo.Topology((jtopo.PU(4.0, 1.0), jtopo.PU(1.0, 10.0),
                        jtopo.PU(1.0, 10.0), jtopo.PU(1.0, 10.0)), (2, 2))
    out.append(("saturated_pod", t, 14.0, {}))
    out.append(("saturated_pod_pods2", t, 14.0, dict(tree=2)))
    t = jtopo.scale_to_load(jtopo.Topology.topo1(8, 2 / 8, 4.0, 5.2), 256,
                            1.5)
    out.append(("system_batch", t, 256.0, dict(tree=np.array(
        [0, 1, 0, 1, 0, 1, 0, 1]))))
    rng = np.random.default_rng(11)
    for i in range(6):              # fixed draws of test_block_sizes' strategy
        k = int(rng.integers(1, 13))
        spec = [(float(rng.uniform(0.1, 32.0)), float(rng.uniform(0.5, 64.0)))
                for _ in range(k)]
        t = jtopo.Topology(tuple(jtopo.PU(s, m, f"p{j}")
                                 for j, (s, m) in enumerate(spec)))
        n = float(rng.uniform(1.0, 999.0)) / 1000.0 * t.total_memory
        out.append((f"draw{i}_k{k}", t, n, {}))
    return [(name, t, _pair_topo(t), n, kw) for name, t, n, kw in out]


@pytest.mark.parametrize("name,jt,tt,n,kw", _topos(),
                         ids=[c[0] for c in _topos()])
def test_algorithm1_helpers_bit_equal(name, jt, tt, n, kw):
    np.testing.assert_array_equal(tbs.tree_target_block_sizes(n, tt, **kw),
                                  jbs.tree_target_block_sizes(n, jt, **kw))
    np.testing.assert_array_equal(tbs.saturated_mask(n, tt),
                                  jbs.saturated_mask(n, jt))
    batch = max(int(n), 1)
    want = jbs.hetero_batch_split(batch, jtopo.scale_to_load(jt, batch, 1.5))
    got = tbs.hetero_batch_split(batch, ttopo.scale_to_load(tt, batch, 1.5))
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_hetero_batch_split_framework_hook():
    """``tests/test_system.py``'s case on the port."""
    topo = ttopo.Topology.topo1(8, 2 / 8, 4.0, 5.2)
    shares = tbs.hetero_batch_split(256, ttopo.scale_to_load(topo, 256, 1.5))
    assert shares.sum() == 256
    assert shares[0] > shares[-1]
    assert np.all(shares >= 0)


def test_tree_targets_absorb_saturation_within_subtree():
    """``tests/test_tree_partition.py``'s case on the port."""
    topo = ttopo.Topology((ttopo.PU(4.0, 1.0), ttopo.PU(1.0, 10.0),
                           ttopo.PU(1.0, 10.0), ttopo.PU(1.0, 10.0)), (2, 2))
    tw = tbs.tree_target_block_sizes(14.0, topo)
    assert (tw <= topo.memories + 1e-9).all()
    assert tw.sum() == pytest.approx(14.0)
    assert tw[0] == pytest.approx(1.0)
    agg = topo.pod_aggregate(2)
    np.testing.assert_allclose([tw[:2].sum(), tw[2:].sum()],
                               tbs.waterfill(14.0, agg.speeds, agg.memories))
