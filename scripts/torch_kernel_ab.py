"""Time the port's f32 fused kernel (#1) and f32 classic forward (#3) of
one checkout on the card, for comparing two commits in one machine.

    python scripts/torch_kernel_ab.py <checkout> <label>

Imports ``sparsetpu_torch`` from ``<checkout>`` (which builds its own
kernels under ``<checkout>/build/``), packs the headline matrix of
``bench.py`` (200k x 100k, density 5e-4, seed 1, f32) and prints, for each
kernel, the median time of one call (CUDA events, 50 calls) and the time a
call back to back (``bench/harness.py:stream_ms``), on lines starting with
``AB <label>``.  Run the two checkouts in turns (A, B, B, A) in one
command, so both land on the same card.
"""

import os
import sys


def main() -> int:
    tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import sparsetpu_torch as st
    from sparsetpu_torch import _host
    from sparsetpu_torch.bench.harness import call_ms, stream_ms
    if not st.__file__.startswith(tree):
        raise RuntimeError(f"imported {st.__file__}, not the checkout {tree}")
    m = _host.random_csr(200_000, 100_000, density=0.0005, seed=1,
                         dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    fused = st.FusedDevice.from_packed(_host.pack_fused(m), "cuda")
    x2 = fused.prepare_x(x)
    classic = st.GStreamDevice(_host.pack_gstream(m, shuffle_lanes=True),
                               "cuda")
    cx = classic.prepare_x(x)
    for name, fn in (("fused f32", lambda: fused.blocks(x2)),
                     ("forward f32", lambda: classic.stream(cx))):
        print(f"AB {label} {name}: {call_ms(fn, 'cuda'):.4f} ms a call, "
              f"{stream_ms(fn, 'cuda'):.4f} ms back to back", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
