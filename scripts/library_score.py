#!/usr/bin/env python3
"""Time the one PyTorch call that computes ``gmm_score``'s function beside
the kernel, on the card.

    python3 scripts/library_score.py [--shapes N,D,K ...]

The call is ``torch.distributions.MultivariateNormal(loc=means,
precision_matrix=U U^T).log_prob(X[:, None, :])``, the (N, K) Gaussian log
densities of `repro_torch.kernels.ref.gmm_score_ref`. The distribution is
built once (its Cholesky factorisation checks its result on the host).
Per shape, on `chip_smoke.py::make_params`' inputs with U in the EM loop's
layout: one eager call timed with CUDA events, its largest absolute error
against the kernel and whether that is within the kernel's float32
tolerance (rtol 1e-5, atol 1e-4); where it agrees, the call and the kernel
in `chip_smoke.py::device_ms` (a CUDA graph of ``reps`` calls, replayed).
A call that disagrees is not captured: at N=2^20 its capture crashed the
process. Prints one JSON line a shape, with the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["2880,3,3", "1048576,3,3", "1048576,4,4"])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for shape in args.shapes:
        N, D, K = (int(v) for v in shape.split(","))
        X, means, U = cs.make_params(N, D, K, 5, torch.float32)
        U = cs.path_layout(U)
        Uc = U.contiguous()
        mvn = torch.distributions.MultivariateNormal(
            loc=means, precision_matrix=Uc @ Uc.transpose(-1, -2),
            validate_args=False)
        want = ops.gmm_score(X, means, U)
        mvn.log_prob(X[:, None, :])  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = mvn.log_prob(X[:, None, :])
        end.record()
        torch.cuda.synchronize()
        agrees = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-4))
        line = {"shape": [N, D, K], "card": card,
                "library_eager_ms": start.elapsed_time(end),
                "library_max_abs_err": float((got - want).abs().max()),
                "library_agrees": agrees,
                "kernel_ms": cs.device_ms(lambda: ops.gmm_score(X, means, U),
                                          args.reps),
                "bound_ms": cs.bound_ms("gmm_score", N, D, K)[0]}
        if agrees:
            line["library_ms"] = cs.device_ms(
                lambda: mvn.log_prob(X[:, None, :]), args.reps)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
