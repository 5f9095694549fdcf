"""The port's token-serving launcher on the CPU: the CLI's lines, the
numbers its core returns, and what it refuses.

Sampled ids cannot match the reference's (``jax.random.categorical`` and a
``torch.Generator`` draw differently), so parity of the model is held on
teacher-forced logits in tests/test_torch_lm.py; here the prompts are
checked to be the reference's (``np.random.default_rng(0)``).
"""
import ast
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.serve import main as jax_main
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve


def test_gen_zero_prints_decode_skipped(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "1",
                "--prompt-len", "4", "--gen", "0"])
    out = capsys.readouterr().out
    assert "decode skipped (--gen 0)" in out
    assert "ms/token" not in out


def test_cli_prints_rate_and_ids(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen1.5-smoke batch=2 prompt=16 gen=3")
    assert "ms/token" in lines[1] and "tok/s" in lines[1]
    ids = ast.literal_eval(lines[2].split(":", 1)[1])
    prompts = np.random.default_rng(0).integers(0, 256, size=(2, 16),
                                                dtype=np.int32)
    assert ids[:16] == prompts[0].tolist() and len(ids) == 19


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2.5-14b",
                                  "olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_serve_tokens_numbers(arch):
    cfg = get_config(arch, smoke=True)
    r = serve.serve_tokens(cfg, batch=3, prompt_len=16, gen=5,
                           temperature=0.8, device="cpu")
    assert r["tokens"].shape == (3, 21)
    gen = r["tokens"][:, 16:]
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert r["logits"].shape == (3, 1, cfg.vocab_padded)
    assert torch.isfinite(r["logits"]).all()
    assert r["prefill_ms"] > 0 and r["decode_ms_per_token"] > 0
    assert r["tok_per_s"] > 0
    # on the CPU the wrappers take their plain versions: no launches
    assert not any(r["launches_prefill"].values())
    assert not any(r["launches_decode"].values())
    again = serve.serve_tokens(cfg, batch=3, prompt_len=16, gen=5,
                               temperature=0.8, device="cpu")
    np.testing.assert_array_equal(again["tokens"], r["tokens"])


def test_serve_tokens_at_head_dim_80():
    """stablelm-smoke widened to stablelm-3b's head dim of 80 serves on the
    CPU: finite logits, ids in range, no kernel launches."""
    cfg = dataclasses.replace(get_config("stablelm-3b", smoke=True),
                              d_model=160, n_heads=2, n_kv_heads=2,
                              head_dim=80)
    r = serve.serve_tokens(cfg, batch=2, prompt_len=32, gen=4,
                           temperature=0.8, device="cpu")
    assert r["tokens"].shape == (2, 36)
    gen = r["tokens"][:, 32:]
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert torch.isfinite(r["logits"]).all()
    assert not any(r["launches_prefill"].values())
    assert not any(r["launches_decode"].values())


def test_sample_clamps_and_stays_in_range():
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros(4, 512)
    logits[:, 300:] = 50.0              # mass on ids past a vocab of 300
    tok = serve.sample(logits, 0.8, gen)
    assert (tok >= 300).all()
    assert (torch.clamp_max(tok, 299) == 299).all()


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-tiny"])
def test_non_dense_arch_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--gen", "1"])


def test_moe_arch_serves_from_the_cli(capsys, monkeypatch):
    """``--arch olmoe-1b-7b --smoke`` serves on the CPU: the reference's
    first line and prompt ids, 32 + 2 ids printed."""
    argv = ["--arch", "olmoe-1b-7b", "--smoke", "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jax_main()
    want = capsys.readouterr().out.splitlines()
    serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(want[0] + " ")
    assert got[0].startswith("arch=olmoe-smoke batch=4 prompt=32 gen=2")
    assert "ms/token" in got[1]
    ids = ast.literal_eval(got[2].split(":", 1)[1])
    assert len(ids) == 34
    assert ids[:32] == ast.literal_eval(want[2].split(":", 1)[1])[:32]


def test_solver_mode_raises(monkeypatch):
    """``--solver`` is ported (``tests/test_torch_solver_service.py`` runs
    it on the CPU); without ``--device`` it takes the card, and without a
    card it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--solver", "--requests", "1"])


def test_bf16_serves():
    cfg = dataclasses.replace(get_config("stablelm-3b", smoke=True),
                              dtype="bfloat16")
    r = serve.serve_tokens(cfg, batch=2, prompt_len=8, gen=2,
                           device="cpu")
    assert r["logits"].dtype == torch.bfloat16
    assert torch.isfinite(r["logits"].float()).all()


def test_cli_matches_reference_cli_lines(capsys, monkeypatch):
    """The same flags give the reference's first line and the same prompt
    ids (the generated ids differ by generator)."""
    argv = ["--smoke", "--batch", "1", "--prompt-len", "6", "--gen", "2"]
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jax_main()
    want = capsys.readouterr().out.splitlines()
    serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith(want[0] + " ")
    assert ast.literal_eval(got[2].split(":", 1)[1])[:6] == \
        ast.literal_eval(want[2].split(":", 1)[1])[:6]
