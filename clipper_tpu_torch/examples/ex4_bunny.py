"""Example 4: Stanford-bunny registration at 90% outliers.

Counterpart of ``examples/ex4_bunny.py`` (reference:
examples/matlab/ex4_bunny.m and examples/python/ex4_bunny.ipynb): m=1000
putative associations on bun10k with 90% outliers; solve, report
precision/recall, and recover the SE(3) transform from the selected
inliers. Also a user-defined invariant written in torch: a
PairwiseInvariant subclass of the user's own with no device score
(``cuda_score()`` gives None) builds through the plain dense build on
every device, and gives the same answer. One whose ``cuda_score()``
gives an ``invariants.DeviceScore`` (its score as C++, csrc/
user_score.cuh; bench/user_scores.py has two) builds on the card through
the build kernels, compiled for it at first use.

Run: python -m clipper_tpu_torch.examples.ex4_bunny [--device=cuda|cpu]
"""

import time

import numpy as np
import torch

import clipper_tpu_torch as ct
from clipper_tpu_torch.bench import data, harness
from clipper_tpu_torch.utils.transforms import kabsch_se3


class MyCustomEuclidean(ct.PairwiseInvariant):
    """A user-defined invariant in plain torch: same math as the builtin."""

    def __init__(self, sigma=0.015, epsilon=0.05):
        self.sigma, self.epsilon = sigma, epsilon

    def __call__(self, ai, aj, bi, bj):
        l1 = torch.linalg.vector_norm(ai - aj, dim=-1)
        l2 = torch.linalg.vector_norm(bi - bj, dim=-1)
        c = torch.abs(l1 - l2)
        return torch.where(c < self.epsilon,
                           torch.exp(-0.5 * c * c / self.sigma ** 2), 0.0)


def main(argv=None):
    _, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    m, rho = 1000, 0.90
    rng = np.random.default_rng(0)
    pcd0 = harness.load_bunny().astype(np.float32)
    pcd1, A, Agt = harness.make_problem(pcd0, m, rho, rng)
    pcd1 = pcd1.astype(np.float32)

    def run(invariant):
        clipper = ct.Clipper(invariant, ct.Params(), dtype=torch.float32,
                             device=dev)
        t0 = time.perf_counter()
        clipper.score_pairwise_consistency(pcd0.T, pcd1.T, A)
        clipper.solve(generator=torch.Generator().manual_seed(0))
        Ain = clipper.get_selected_associations()
        return Ain, time.perf_counter() - t0

    Ain, t = run(harness.default_invariant())
    p, r = data.get_precision_recall(Ain, Agt)
    print(f"built-in invariant: {Ain.shape[0]} inliers of {m} putative "
          f"({rho*100:.0f}% outliers) in {t*1e3:.1f} ms "
          f"-> precision {p*100:.1f}%  recall {r*100:.1f}%")
    assert p >= 0.995 and r >= 0.85, (p, r)

    R, tvec = kabsch_se3(torch.as_tensor(pcd0[Ain[:, 0]], device=dev),
                         torch.as_tensor(pcd1[Ain[:, 1]], device=dev))
    R, tvec = R.cpu().numpy(), tvec.cpu().numpy()
    r_ok = np.allclose(R, np.eye(3), atol=0.01)
    print("recovered R ~ I:", r_ok, " |t| =", f"{np.linalg.norm(tvec):.4f}")
    assert r_ok and np.linalg.norm(tvec) < 0.01

    # the user's own invariant: same answer, built plain on any device
    Ain2, t2 = run(MyCustomEuclidean())
    p2, r2 = data.get_precision_recall(Ain2, Agt)
    print(f"custom torch invariant: precision {p2*100:.1f}% recall "
          f"{r2*100:.1f}% in {t2*1e3:.1f} ms (reference custom-Python "
          "path: ~6000 ms)")
    assert p2 >= 0.995 and r2 >= 0.85, (p2, r2)
    return dict(precision=p, recall=r, custom_precision=p2,
                custom_recall=r2)


if __name__ == "__main__":
    main()
