"""``cg_graph_share`` on hand-built traces: the traced iterations that
hold a graph replay, over the iterations the sets ran; 0 where every
iteration ran eagerly; None without a trace or its iteration spans."""

import pytest
import torch

from spbench import harness
from spbench.timing import Event, Trace

READ = harness.metric_readers()["cg_graph_share"].read


def _run(trace, iterations):
    r = harness.Run("c", {}, {}, 0, 1.0, True, torch.device("cpu"),
                    "NVIDIA H100 80GB HBM3")
    r.traces = {} if trace is None else {"cg": trace}
    r.counts = {"trace_iterations": iterations}
    return r


def _trace(replay):
    """Three passes of one set: two iterations, then the pass that holds
    its test alone; each iteration its check, and with ``replay`` its
    graph's launch."""
    host = [Event("sparsetpu.pcg", 0, 100)]
    for lo in (10, 40):
        host += [Event("sparsetpu.pcg.iter", lo, lo + 30),
                 Event("sparsetpu.pcg.check", lo, lo + 10)]
        if replay:
            host += [Event("sparsetpu.pcg.replay", lo + 12, lo + 20),
                     Event("cudaGraphLaunch", lo + 13, lo + 19)]
    host += [Event("sparsetpu.pcg.iter", 70, 80),
             Event("sparsetpu.pcg.check", 70, 80),
             Event("sparsetpu.pcg.replay", 85, 90)]     # outside any pass
    return Trace([Event("k", 15, 60)], host, (0.0, 100.0), True)


@pytest.mark.parametrize("replay, share", [(True, 1.0), (False, 0.0)])
def test_share_of_iterations_replayed(replay, share):
    assert READ(_run(_trace(replay), 2)) == share


def test_none_without_the_iterations():
    assert READ(_run(None, 2)) is None
    assert READ(_run(_trace(True), 0)) is None
    bare = _trace(True)
    bare = bare._replace(host=[e for e in bare.host
                               if not e.name.startswith("sparsetpu.pcg.iter")])
    assert READ(_run(bare, 2)) is None
