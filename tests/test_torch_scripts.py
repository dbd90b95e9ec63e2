"""The port's sweep scripts (``covo_mpc_tpu_torch/scripts/``) on the CPU.

``paper_results``, ``mode_gates`` and ``n_ablation`` run their cells at
N=16, H=4, one 300-step episode a cell (PID, MPPI and CoVO offline: a CoVO
online episode takes tens of seconds here), through each script's
function that runs its matrix at a given ``total_steps``. Each cell equals
``evaluate(env, solver, total_steps=300, seed=1)`` run directly with the
same settings, bit for bit; the files they write hold the JAX scripts'
table lines (``scripts/paper_results.py:120-146``,
``scripts/mode_gates.py:140-168``, ``scripts/n_ablation.py:108-130``),
spelled out here; mode_gates rewrites only its marked section, and appends
it where the markers are absent; a second run over the same checkpoint
root is all cached and writes the same bytes; ``--fresh`` recomputes the
same numbers; a key-drawing sampler and the fwd_fwd offline schedule run
in supervised cells; and without ``--device cpu`` a script raises where
there is no card (there is no CPU fallback).
"""

import json
import shutil

import pytest
import torch

from covo_mpc_tpu_torch.runtime import evaluate
from covo_mpc_tpu_torch.scripts import make_env, mode_gates, n_ablation, paper_results
from covo_mpc_tpu_torch.solvers import get_solver

PSTR = "N16_H4_lam0.01"
SMALL = ["--device", "cpu", "--h", "4"]
STEPS = 300  # one episode a cell
# each controller's settings as the scripts pass them by default
SETTINGS = {
    "pid": dict(rng_mode="fast", hessian_mode="fwd_fwd", engine="torch"),
    "mppi": dict(rng_mode="fast", hessian_mode="fwd_fwd", engine="torch"),
    "covo_offline": dict(rng_mode="fast", hessian_mode="adjoint", engine="torch",
                         sigma_mode="ns"),
}


@pytest.fixture(scope="module")
def direct():
    """evaluate(env, solver, total_steps=300, seed=1) of each controller,
    run directly: its err_pos mean and std in cm."""
    env = make_env("tracking_zigzag", "gaussian", "cpu")
    out = {}
    for name, kw in SETTINGS.items():
        solver, _ = get_solver(env, name, PSTR, collect_debug=False, **kw)
        res = evaluate(env, solver, total_steps=STEPS, seed=1)
        out[name] = (res.mean * 100, res.std * 100)
    return out


def _paper_args(d, *extra):
    return paper_results.build_parser().parse_args(
        [*SMALL, "--n", "16", "--engine", "torch", "--out", str(d / "RESULTS_TORCH.md"),
         "--checkpoint-root", str(d / "ckpt"), *extra])


@pytest.fixture(scope="module")
def paper(tmp_path_factory):
    d = tmp_path_factory.mktemp("paper")
    args = _paper_args(d, "--controllers", "pid", "mppi", "covo_offline")
    rows = paper_results.run(args, STEPS)
    return d, args, rows, (d / "RESULTS_TORCH.md").read_text()


def test_paper_results_cells_equal_evaluate(paper, direct):
    _, _, rows, _ = paper
    assert [r["name"] for r in rows] == ["pid", "mppi", "covo_offline"]
    for r in rows:
        assert (r["mean"], r["std"]) == direct[r["name"]], r["name"]
        assert r["failed"] == 0 and not r["cached"]


def test_paper_results_table_lines(paper, direct):
    _, _, _, text = paper
    m = direct["mppi"][0]
    rel = {name: "—" if name == "mppi" else f"{(1 - v[0] / m) * 100:+.1f}%"
           for name, v in direct.items()}
    lines = text.splitlines()
    assert lines[:6] == [
        "# Results — tracking_zigzag, N=16, H=4, lam=0.01, noDR",
        "",
        "Protocol: 1 episodes = 4 fixed trajectories x 0 reps x 300 steps @ 50 Hz "
        "(reference: quadrotor.py:506-591). Error = mean ||pos - pos_tar|| over the "
        "episode, in cm. Device: cpu. Fast path: engine=torch, sigma_mode=ns, "
        "adjoint Hessian, fast sampler.",
        "",
        "| controller | err_pos (cm) | vs MPPI |",
        "|---|---|---|",
    ]
    assert lines[6:9] == [f"| {name} | {v[0]:.2f} ± {v[1]:.2f} | {rel[name]} |"
                          for name, v in direct.items()]
    assert lines[9] == ""
    assert lines[10].startswith("Host wall per cell (s): pid ")
    assert lines[10].endswith("; failed episodes: pid 0, mppi 0, covo_offline 0.")


def test_paper_results_rerun_is_cached_and_writes_the_same_bytes(paper):
    d, args, rows, text = paper
    again = paper_results.run(args, STEPS)
    assert all(r["cached"] for r in again)
    assert [(r["mean"], r["std"], r["wall"]) for r in again] == \
        [(r["mean"], r["std"], r["wall"]) for r in rows]
    assert (d / "RESULTS_TORCH.md").read_text() == text


def test_paper_results_fresh_recomputes_the_same_numbers(paper, tmp_path):
    d, _, rows, _ = paper
    shutil.copytree(d / "ckpt", tmp_path / "ckpt")
    fresh = paper_results.run(_paper_args(tmp_path, "--fresh", "--controllers", "pid",
                                          "mppi"), STEPS)
    assert not any(r["cached"] for r in fresh)
    assert [(r["mean"], r["std"]) for r in fresh] == \
        [(r["mean"], r["std"]) for r in rows[:2]]


# --- mode_gates ---------------------------------------------------------------------

MATRIX = [("mppi fast (anchor)", "mppi", "fast", "adjoint", 16),
          ("pid", "pid", "fast", "adjoint", 16)]
HEAD, TAIL = "# Results\n\nkept above\n\n", "\n\nkept below\n"


def _gates_args(d, out):
    return mode_gates.build_parser().parse_args(
        [*SMALL, "--n", "16", "--engine", "torch", "--out", str(out),
         "--json", str(d / "gates.json"), "--checkpoint-root", str(d / "ckpt")])


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    d = tmp_path_factory.mktemp("gates")
    out = d / "RESULTS_TORCH.md"
    out.write_text(HEAD + mode_gates.BEGIN + "\nan older section\n" + mode_gates.END + TAIL)
    args = _gates_args(d, out)
    rows = mode_gates.run(args, STEPS, MATRIX)
    return d, args, rows, out.read_text()


def test_mode_gates_cells_equal_evaluate(gates, direct):
    d, _, rows, _ = gates
    for r, (tag, name, *_rest) in zip(rows, MATRIX):
        assert r["tag"] == tag and (r["mean"], r["std"]) == direct[name]
        assert r["failed"] == 0
    assert json.loads((d / "gates.json").read_text()) == rows


def test_mode_gates_rewrites_only_its_section(gates, direct):
    _, _, _, text = gates
    assert text.startswith(HEAD + mode_gates.BEGIN) and text.endswith(mode_gates.END + TAIL)
    body = text[len(HEAD):-len(TAIL)].splitlines()
    m, p = direct["mppi"], direct["pid"]
    assert body == [
        mode_gates.BEGIN,
        "## Speed-mode quality gates (full 40-episode protocol)",
        "",
        "Same protocol as above (1 episodes, tracking_zigzag, H=4, lam=0.01, noDR, "
        "engine=torch, sigma_mode=ns); device cpu. Each non-parity speed mode the port "
        "runs, gated on tracking quality. 'vs MPPI' compares against the same-run "
        "fast-sampler MPPI anchor.",
        "",
        "| mode | N | err_pos (cm) | vs MPPI |",
        "|---|---|---|---|",
        f"| mppi fast (anchor) | 16 | {m[0]:.2f} ± {m[1]:.2f} | anchor |",
        f"| pid | 16 | {p[0]:.2f} ± {p[1]:.2f} | {(1 - p[0] / m[0]) * 100:+.1f}% |",
        "",
        "Raw rows: `gates.json` (includes per-run wall time).",
        mode_gates.END,
    ]


def test_mode_gates_second_run_leaves_the_file_as_it_is(gates):
    d, args, _, text = gates
    mode_gates.run(args, STEPS, MATRIX)
    assert (d / "RESULTS_TORCH.md").read_text() == text


def test_mode_gates_appends_the_section_without_markers(gates):
    d, _, _, text = gates
    out = d / "other.md"
    out.write_text("one line\n")
    mode_gates.run(_gates_args(d, out), STEPS, MATRIX)
    section = text[len(HEAD):-len(TAIL)]
    assert out.read_text() == "one line\n\n" + section + "\n"
    # and a file that does not exist yet holds the section alone
    assert mode_gates.rewrite("", section) == "\n\n" + section + "\n"


def test_mode_gates_marks_the_n_ablation_rows():
    args = mode_gates.build_parser().parse_args(["--n", "8192", "--json", "x.json"])
    rows = [dict(tag="mppi fast (anchor)", n=8192, mean=7.0, std=0.5),
            dict(tag="covo gn+kernel-rng N=1024", n=1024, mean=4.0, std=0.25)]
    lines = mode_gates.section(args, rows, 12000, "a card").splitlines()
    assert lines[3].startswith("Same protocol as above (40 episodes, tracking_zigzag, "
                               "H=32, lam=0.01, noDR, engine=cuda, sigma_mode=ns); "
                               "device a card.")
    assert lines[7:9] == ["| mppi fast (anchor) | 8192 | 7.00 ± 0.50 | anchor |",
                          "| covo gn+kernel-rng N=1024 | 1024 | 4.00 ± 0.25 | (N-ablation) |"]


# --- n_ablation ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ablation(tmp_path_factory):
    d = tmp_path_factory.mktemp("ablation")
    args = n_ablation.build_parser().parse_args(
        [*SMALL, "--ns", "16", "--controllers", "mppi", "covo_offline",
         "--out", str(d / "RESULTS_N_TORCH.md"), "--checkpoint-root", str(d / "ckpt")])
    cells = n_ablation.run(args, STEPS)
    return d, args, cells, (d / "RESULTS_N_TORCH.md").read_text()


def test_n_ablation_cells_equal_evaluate(ablation, direct):
    _, _, cells, _ = ablation
    assert list(cells) == [(16, "mppi"), (16, "covo_offline")]
    for (_, name), c in cells.items():
        assert (c["mean"], c["std"]) == direct[name] and c["failed"] == 0


def test_n_ablation_table_lines(ablation, direct):
    _, _, _, text = ablation
    m, o = direct["mppi"], direct["covo_offline"]
    lines = text.splitlines()
    assert lines[:7] == [
        "# N-ablation — tracking_zigzag, H=4, lam=0.01, noDR",
        "",
        "Protocol: 1 episodes per cell (reference sweep: scripts/covo_quadrotor_N.sh). "
        "err_pos in cm, mean ± std over episodes. Device: cpu. engine=auto (the "
        "hand-written CUDA kernels on the card at every N — a block's idle lanes "
        "masked), adjoint Hessian, ns designer, fast sampler.",
        "",
        "| N | mppi | covo_offline | CoVO-on vs MPPI |",
        "|---|---|---|---|",
        f"| 16 | {m[0]:.2f} ± {m[1]:.2f} | {o[0]:.2f} ± {o[1]:.2f} | — |",
    ]
    assert lines[8].startswith("Host wall per cell (s): N=16 mppi ")
    assert lines[8].endswith("; failed episodes: 0.")
    # the relative column, where both controllers ran
    args = n_ablation.build_parser().parse_args(["--ns", "16"])
    res = {(16, "mppi"): dict(mean=8.0, std=1.0, wall=1.0, failed=0),
           (16, "covo_online"): dict(mean=4.0, std=0.5, wall=1.0, failed=0),
           (16, "covo_offline"): dict(mean=6.0, std=0.75, wall=1.0, failed=0)}
    row = n_ablation.table(args, res, 12000, "a card").splitlines()[6]
    assert row == "| 16 | 8.00 ± 1.00 | 4.00 ± 0.50 | 6.00 ± 0.75 | +50.0% |"


def test_n_ablation_rerun_is_cached_and_writes_the_same_bytes(ablation):
    d, args, cells, text = ablation
    again = n_ablation.run(args, STEPS)
    assert all(c["cached"] for c in again.values())
    assert (d / "RESULTS_N_TORCH.md").read_text() == text


# --- refusals -----------------------------------------------------------------------


@pytest.mark.parametrize("flags, name, kw", [
    (["--rng", "invariant", "--controllers", "mppi"], "mppi",
     dict(rng_mode="invariant", hessian_mode="fwd_fwd", engine="torch")),
    (["--hessian-mode", "fwd_fwd", "--controllers", "covo_offline"], "covo_offline",
     dict(rng_mode="fast", hessian_mode="fwd_fwd", engine="torch", sigma_mode="ns")),
], ids=["invariant", "fwd_fwd"])
def test_modes_that_raised_run_supervised(tmp_path, flags, name, kw):
    """A key-drawing sampler in a supervised cell (the chunk's carry is the
    key, as JAX's) and CoVO offline's fwd_fwd schedule: each cell equals
    evaluate() of the same solver bit for bit and its row is in the table."""
    args = _paper_args(tmp_path, *flags)
    (row,) = paper_results.run(args, STEPS)
    env = make_env("tracking_zigzag", "gaussian", "cpu")
    solver, _ = get_solver(env, name, PSTR, collect_debug=False, **kw)
    res = evaluate(env, solver, total_steps=STEPS, seed=1)
    assert (row["mean"], row["std"]) == (res.mean * 100, res.std * 100)
    assert row["failed"] == 0
    assert f"| {name} | {row['mean']:.2f} ± {row['std']:.2f} |" in (
        tmp_path / "RESULTS_TORCH.md").read_text()


@pytest.mark.parametrize("script", [paper_results, mode_gates, n_ablation],
                         ids=["paper_results", "mode_gates", "n_ablation"])
def test_the_card_is_the_default_and_there_is_no_cpu_fallback(script, tmp_path,
                                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ["--out", str(tmp_path / "R.md"), "--checkpoint-root", str(tmp_path / "ckpt")]
    if script is mode_gates:
        out += ["--json", str(tmp_path / "r.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--quick", *out])
    assert list(tmp_path.iterdir()) == []
    if script is not n_ablation:
        with pytest.raises(ValueError, match="--engine cuda"):
            script.main(["--device", "cpu", *out])


@pytest.mark.parametrize("name", ["RESULTS.md", "RESULTS_N.md", "RESULTS_DRAG.md"])
def test_the_tpu_results_files_are_never_written(name, tmp_path):
    with pytest.raises(ValueError, match="TPU results"):
        paper_results.main([*SMALL, "--engine", "torch", "--out", str(tmp_path / name),
                            "--checkpoint-root", str(tmp_path / "ckpt")])
    with pytest.raises(ValueError, match="TPU results"):
        mode_gates.main([*SMALL, "--engine", "torch", "--out", str(tmp_path / "R.md"),
                         "--json", str(tmp_path / "results_mode_gates.json"),
                         "--checkpoint-root", str(tmp_path / "ckpt")])
    assert list(tmp_path.iterdir()) == []
