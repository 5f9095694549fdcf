"""The CLI contract of ``python -m repro_torch.analysis``: exit code 0 iff
no pass reported anything, and the ``text`` / ``json`` / ``github``
formats, for every subcommand — run in process (``main(argv)``), on the
CPU: ``verify`` builds there by default, ``partners`` and ``trace`` are
given ``--device cpu`` (their default is the card)."""
import json
import textwrap

import pytest
import torch

import repro_torch.analysis.trace as ttrace
import repro_torch.analysis.verify as tverify
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.diagnostics import Report


@pytest.fixture()
def offender_dir(tmp_path):
    bad = tmp_path / "repro_torch" / "sparse" / "mod.py"
    bad.parent.mkdir(parents=True)
    bad.write_text(textwrap.dedent("""\
        import torch.distributed

        def f(x):
            return x.item()
    """))
    return tmp_path


def test_lint_clean_exits_zero(tmp_path, capsys):
    ok = tmp_path / "fine.py"
    ok.write_text("x = 1\n")
    assert main(["lint", str(ok)]) == 0
    assert "0 failing" in capsys.readouterr().out


def test_lint_offender_exits_nonzero(offender_dir, capsys):
    assert main(["lint", str(offender_dir)]) == 1
    out = capsys.readouterr().out
    assert "TORCH001" in out and "TORCH004" in out and "1 failing" in out


def test_lint_json_format(offender_dir, capsys):
    assert main(["lint", str(offender_dir), "--format=json"]) == 1
    reports = json.loads(capsys.readouterr().out)
    assert isinstance(reports, list) and not reports[0]["ok"]
    got = {(d["code"], d["where"].rpartition(":")[2])
           for d in reports[0]["diagnostics"]}
    assert got == {("TORCH001", "1"), ("TORCH004", "4")}
    assert reports[0]["info"]["files"] == 1


def test_lint_github_format(offender_dir, capsys, monkeypatch):
    monkeypatch.chdir(offender_dir)
    assert main(["lint", "repro_torch", "--format=github"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert ("::error file=repro_torch/sparse/mod.py,line=1::TORCH001: "
            in "\n".join(lines))
    assert all(line.startswith("::error file=") for line in lines)


def test_verify_clean_exits_zero(capsys):
    assert main(["verify", "--n", "80", "--fanouts", "2,2",
                 "--generator", "grid_2d"]) == 0
    out = capsys.readouterr().out
    assert "[OK] grid_2d/tree (2, 2)" in out and "0 failing" in out


@pytest.mark.parametrize("fmt", ["text", "json", "github"])
def test_verify_failure_exits_nonzero(fmt, capsys, monkeypatch):
    def broken(plan):
        rep = Report(subject="broken")
        rep.add("PLAN006", "halo slot written twice", where="level 0")
        return rep

    monkeypatch.setattr(tverify, "verify_plan", broken)
    assert main(["verify", "--n", "64", "--fanouts", "4",
                 f"--format={fmt}"]) == 1
    out = capsys.readouterr().out
    if fmt == "json":
        reports = json.loads(out)
        assert [d["code"] for r in reports for d in r["diagnostics"]] == \
            ["PLAN006", "PLAN006"]          # grid_2d and rgg_2d, flat k=4
    elif fmt == "github":
        assert out.count("::error::") == 2 and "[level 0]" in out
    else:
        assert "PLAN006 [level 0]" in out and "2 failing" in out


def test_partners_prints_the_table(capsys):
    assert main(["partners", "--fanouts", "2,2", "--format=json",
                 "--device", "cpu"]) == 0
    flat, tree = json.loads(capsys.readouterr().out)
    assert flat["subject"] == "grid_2d/flat k=4"
    assert tree["subject"] == "grid_2d/tree (2, 2)"
    assert set(flat["info"]["partners"]) == {"0"}
    partners = tree["info"]["partners"]
    assert set(partners) == {"0", "1"}
    assert all(len(pair) == 2 for rounds in partners.values()
               for pairs in rounds for pair in pairs)


def test_trace_clean_exits_zero(capsys):
    assert main(["trace", "--backend", "coo", "--backend", "dist_halo",
                 "--backend", "dist_hier", "--n", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "payload bytes per level" in out and "0 failing" in out


def test_trace_json_carries_the_exchange(capsys):
    assert main(["trace", "--backend", "dist_hier", "--fanouts", "2,2,2",
                 "--n", "64", "--nb", "2", "--format=json",
                 "--device", "cpu"]) == 0
    (rep,) = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["info"]["exchange"]["nb"] == 2
    assert len(rep["info"]["exchange"]["payload_bytes_lvl"]) == 3


def test_trace_failure_exits_nonzero(capsys, monkeypatch):
    def drifted(backend, **kw):
        rep = Report(subject=backend)
        rep.add("TRACE002", "round differs", where="exchange: level 0")
        return rep

    monkeypatch.setattr(ttrace, "audit_backend", drifted)
    assert main(["trace", "--backend", "dist_halo", "--format=github",
                 "--device", "cpu"]) == 1
    assert capsys.readouterr().out.strip() == (
        "::error::dist_halo [exchange: level 0]: TRACE002: round differs")


@pytest.mark.parametrize("cmd", ["partners", "trace"])
def test_card_is_the_default_device(cmd, monkeypatch):
    """``partners`` and ``trace`` build on the card unless told otherwise,
    and raise without one rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([cmd, "--n", "64", "--fanouts", "2,2"])
