"""Device ms an iteration outside the SpMV's kernels in traced CG sets:
the SpMV's kernels are named by a traced bare ``sm.spmv``, everything else
the sets ran on the device (dots, axpys, the preconditioner, the scalar's
copy) counts."""
KIND, UNIT = "per_layer", "ms"


def read(run):
    tr = run.traces.get("cg")
    its = run.counts.get("trace_iterations")
    if tr is None or not its or not run.spmv_kernels:
        return None
    us = sum(e.end_us - e.start_us for e in tr.device
             if e.name not in run.spmv_kernels)
    return us / its * 1e-3
