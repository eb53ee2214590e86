"""A cell on N ranks, on the CPU with gloo ranks (and on the cards with
NCCL, marked ``gpu``): a test-only cell whose files are written into the
test's root, a small HPCG matrix cut into row bands by a test layout in
plain torch and multiplied by a test traffic kind that all-gathers y.
Also the refusals and failures: a cell on ranks with no layout, a rank
that raises, a rank that hangs; and a one-card run starts no process and
no group."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from spbench import __main__ as entry
from spbench import harness, ranks
from spbench.tests.conftest import make_small_root

REPO = os.path.dirname(harness.ROOT)
SEED = 2 ** 31 + 29

LAYOUT = '''
"""Rank r's band of rows, every band padded to one length, as index
arrays multiplied in plain torch."""
import numpy as np
import torch


class Band:
    def __init__(self, run, csr):
        n = csr.nr_rows
        self.n, self.rows_each = n, -(-n // run.world)
        lo = min(n, run.rank * self.rows_each)
        hi = min(n, lo + self.rows_each)
        s, e = int(csr.row_ptr[lo]), int(csr.row_ptr[hi])
        rows = np.repeat(np.arange(hi - lo), np.diff(csr.row_ptr[lo:hi + 1]))
        self.rows = torch.as_tensor(rows, device=run.device)
        self.cols = torch.as_tensor(csr.col_ind[s:e].astype(np.int64),
                                    device=run.device)
        self.vals = torch.as_tensor(csr.values[s:e], device=run.device)

    def __call__(self, x):
        y = torch.zeros(self.rows_each, dtype=x.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])


def build(run, csr):
    return Band(run, csr)
'''

KIND = '''
"""Each rank multiplies its band and y is all-gathered into every rank;
a sync every ``sync_every`` calls, the window's end agreed by the ranks.
Planted faults for the tests: ``fail_rank`` raises in ``prepare``,
``hang_rank`` sleeps there."""
import os
import time

import torch

from spbench import timing
from spbench.traffic import spmv_loop
from spbench.traffic._sample import Reservoir


class State:
    def __init__(self, sm, pool, xs):
        self.sm, self.pool, self.xs, self.kept = sm, pool, xs, None


def _gather(run, st, x):
    part = st.sm(x)
    if run.group is None:
        return part[:st.sm.n]
    parts = [torch.empty_like(part) for _ in range(run.world)]
    torch.distributed.all_gather(parts, part, group=run.group)
    return torch.cat(parts)[:st.sm.n]


def prepare(run, sm, csr, rng):
    pids = os.path.join(os.path.dirname(os.path.dirname(__file__)), "pids")
    os.makedirs(pids, exist_ok=True)
    with open(os.path.join(pids, str(run.rank)), "w") as f:
        f.write(str(os.getpid()))
    if run.mix.get("fail_rank") == run.rank:
        raise RuntimeError(f"planted fault in rank {run.rank}")
    if run.mix.get("hang_rank") == run.rank:
        time.sleep(3600)
    pool = spmv_loop.make_pool(run.mix, csr, rng)
    st = State(sm, pool, [torch.as_tensor(p, device=run.device)
                          for p in pool])
    for x in st.xs:
        _gather(run, st, x)
    return st


def window(run, st, rng):
    st.kept = Reservoir(int(run.mix["keep"]), rng)
    t0, calls = time.perf_counter(), 0
    while True:
        for _ in range(int(run.mix["sync_every"])):
            i = calls % len(st.xs)
            y = _gather(run, st, st.xs[i])
            calls += 1
        run.sync()
        st.kept.offer((i, y))
        if run.agree(time.perf_counter() - t0 >= run.seconds):
            break
    run.window_s = time.perf_counter() - t0
    run.counts["calls"] = run.counts["attempted"] = calls


def trace(run, st):
    run.traces["gather"] = timing.traced(
        torch, lambda: [_gather(run, st, x) for x in st.xs],
        agree=run.agree)


def outputs(st):
    return [(i, y.cpu().numpy()) for i, y in st.kept.items], st.pool


def judge(run, csr, outs):
    return spmv_loop.judge(run, csr, outs)
'''


def _rank_root(path, chips, **mix):
    """The small root with the test cell ``hpcg6.bands`` on ``chips``
    ranks (``mix`` adds planted faults) and ``hpcg6.spmv2``, a cell on 2
    ranks whose configuration names no layout."""
    root = make_small_root(path)
    cfg = harness.load_json("configs", "hpcg6", str(root))
    cfg.update(name="hpcg6b", layout="row_bands")
    (root / "configs" / "hpcg6b.json").write_text(json.dumps(cfg))
    (root / "layouts").mkdir(exist_ok=True)
    (root / "layouts" / "row_bands.py").write_text(textwrap.dedent(LAYOUT))
    (root / "traffic" / "gather_loop.py").write_text(textwrap.dedent(KIND))
    (root / "traffic" / "gather_stream.json").write_text(json.dumps(
        {"kind": "gather_loop", "pool": 4, "sync_every": 8, "keep": 4,
         **mix}))
    (root / "workloads" / "hpcg6.bands.json").write_text(json.dumps(
        {"config": "hpcg6b", "traffic": "gather_stream", "chips": chips,
         "limits": {"spmv_err": 1e-13}}))
    (root / "workloads" / "hpcg6.spmv2.json").write_text(json.dumps(
        {"config": "hpcg6", "traffic": "spmv_stream", "chips": 2,
         "limits": {"spmv_err": 1e-13}}))
    return root


def _entry(root, cell="hpcg6.bands", device="cpu", allowance_s=None,
           seconds=0.5, trace=0):
    """``python -m spbench`` on ``root``, in a process of its own; its
    output and the seconds it took."""
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = ("import sys; from spbench.__main__ import main; "
            f"sys.exit(main({argv!r}, root={str(root)!r}, "
            f"device={device!r}, allowance_s={allowance_s!r}))")
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    return out, time.monotonic() - t


def _result_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _no_rank_left(root):
    pids = [int((root / "pids" / f).read_text())
            for f in os.listdir(root / "pids")]
    assert pids and not [p for p in pids if _alive(p)]


def test_four_ranks_one_result(tmp_path):
    root = _rank_root(tmp_path, 4)
    out, _ = _entry(root)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = _result_lines(out.stdout)
    assert len(lines) == 1
    r = lines[0]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["count"] == 4
    assert len(r["device"]["per_rank_peak_bytes"]) == 4
    assert r["device"]["memory_peak_bytes"] == max(
        r["device"]["per_rank_peak_bytes"])
    assert list(r)[-1] == "checks"
    assert {"spmv_gnnz_s", "setup_s"} <= set(r["metrics"])
    assert sorted(os.listdir(root / "pids")) == ["0", "1", "2", "3"]
    _no_rank_left(root)


@pytest.mark.parametrize("rank", [0, 2])
def test_rank_that_raises_ends_the_run(tmp_path, rank):
    root = _rank_root(tmp_path, 4, fail_rank=rank)
    out, took = _entry(root)
    assert out.returncode != 0 and not _result_lines(out.stdout)
    assert took < 30
    assert f"rank {rank} failed:" in out.stderr
    assert f"RuntimeError: planted fault in rank {rank}" in out.stderr
    _no_rank_left(root)


def test_rank_that_hangs_is_killed_at_the_limit(tmp_path):
    root = _rank_root(tmp_path, 4, hang_rank=1)
    out, took = _entry(root, allowance_s=20.0)
    assert out.returncode != 0 and not _result_lines(out.stdout)
    assert "outlasted the run's limit of 20 s" in out.stderr
    hung = out.stderr.split("rank 1's stack:")[1].split("rank 2's")[0]
    assert "in prepare" in hung
    assert took < 60
    _no_rank_left(root)


def _refuse(name, *a, **kw):
    raise AssertionError(f"{name} called")


def test_ranks_without_layout_refused(tmp_path, monkeypatch, capsys):
    root = _rank_root(tmp_path, 4)
    monkeypatch.setattr(ranks, "launch", lambda *a, **kw: _refuse("launch"))
    rc = entry.main(["--workload", "hpcg6.spmv2", "--seed", str(SEED),
                     "--seconds", "0.3"], root=str(root), device="cpu")
    assert rc != 0
    out = capsys.readouterr()
    assert out.out == "" and "names no layout" in out.err


def test_one_card_starts_no_process_and_no_group(small_root, monkeypatch,
                                                 capsys):
    dist = torch.distributed
    for name in ("init_process_group", "barrier", "all_reduce"):
        monkeypatch.setattr(dist, name, lambda *a, _n=name, **kw:
                            _refuse(_n))
    monkeypatch.setattr(ranks, "launch", lambda *a, **kw: _refuse("launch"))
    rc = entry.main(["--workload", "hpcg6.spmv", "--seed", str(SEED),
                     "--seconds", "0.3"], root=str(small_root),
                    device="cpu")
    assert rc == 0
    (r,) = _result_lines(capsys.readouterr().out)
    assert r["correct"] is True and r["device"]["count"] == 1
    assert "per_rank_peak_bytes" not in r["device"]
    assert not dist.is_initialized()


def test_merge_devices():
    result = {"device": {"kind": "NVIDIA H100 80GB HBM3", "count": 1,
                         "memory_peak_bytes": 5}}
    parts = [{"kind": "NVIDIA H100 80GB HBM3", "memory_peak_bytes": 9},
             {"kind": "NVIDIA H100 80GB HBM3", "memory_peak_bytes": 7}]
    assert ranks.merge_devices(result, parts) == []
    assert result["device"] == {"kind": "NVIDIA H100 80GB HBM3", "count": 3,
                                "memory_peak_bytes": 9,
                                "per_rank_peak_bytes": [5, 9, 7]}
    parts[1]["kind"] = "NVIDIA A100-SXM4-80GB"
    assert ranks.merge_devices(result, parts) == [
        "NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3",
        "NVIDIA A100-SXM4-80GB"]


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL ranks run on the cards")
    return torch.cuda.device_count()


def _launch_on_cards(root, world, trace, allowance_s=None):
    """``ranks.launch`` on ``world`` cards (one card too, which the entry
    point would run without ranks), in a process of its own; prints the
    result with its device block over the ranks."""
    code = textwrap.dedent(f"""
        import json, time
        from spbench import ranks
        result, parts = ranks.launch("hpcg6.bands", {SEED}, 1.0, {trace},
                                     time.perf_counter(), {world},
                                     root={str(root)!r},
                                     allowance_s={allowance_s!r})
        assert not ranks.merge_devices(result, parts)
        print(json.dumps(result))
    """)
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    return out, time.monotonic() - t


@pytest.mark.gpu
def test_ranks_on_cards(tmp_path, cards):
    root = _rank_root(tmp_path, cards)
    out, _ = _launch_on_cards(root, cards, True)
    assert out.returncode == 0, out.stderr[-4000:]
    (r,) = _result_lines(out.stdout)
    assert r["correct"] is True, r["checks"]
    dev = r["device"]
    assert dev["count"] == cards and len(dev["per_rank_peak_bytes"]) == cards
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    _no_rank_left(root)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["fail_rank", "hang_rank"])
def test_rank_fault_on_cards(tmp_path, cards, fault):
    root = _rank_root(tmp_path, cards, **{fault: cards - 1})
    out, took = _launch_on_cards(root, cards, False, allowance_s=60.0)
    assert out.returncode != 0 and not _result_lines(out.stdout)
    said = {"fail_rank": f"rank {cards - 1} failed:",
            "hang_rank": "outlasted the run's limit"}
    assert said[fault] in out.stderr
    assert took < 120
    _no_rank_left(root)
