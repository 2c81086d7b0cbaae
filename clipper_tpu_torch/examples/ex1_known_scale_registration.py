"""Example 1: synthetic known-scale point-cloud registration.

Counterpart of ``examples/ex1_known_scale_registration.py`` (reference:
examples/matlab/ex1_knownscalepointcloud.m): a 4-point model, an
SE(3)-transformed partial view, all-to-all putative associations, the
Euclidean-distance invariant, an MSRC solve, and SE(3) recovery.

Run: python -m clipper_tpu_torch.examples.ex1_known_scale_registration
         [--device=cuda|cpu]
"""

import numpy as np
import torch

import clipper_tpu_torch as ct
from clipper_tpu_torch.bench import harness
from clipper_tpu_torch.utils.transforms import kabsch_se3, transform_rmse


def main(argv=None):
    _, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    model = np.array([[0, 2, 0, 2],
                      [0, 0, 3, 2],
                      [0, 0, 0, 0]], dtype=np.float64)

    th = np.pi / 8
    R_true = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0],
                       [0, 0, 1]])
    t_true = np.array([5.0, 3.0, 0.0])
    data = R_true.T @ (model - t_true[:, None])
    data = data[:, :3]  # partial view: one point unobserved

    clipper = ct.Clipper(ct.EuclideanDistance(), ct.Params(),
                         dtype=torch.float64, device=dev)
    clipper.score_pairwise_consistency(model, data)  # all-to-all hypothesis
    soln = clipper.solve(generator=torch.Generator().manual_seed(0))

    A_in = clipper.get_selected_associations()
    print(f"selected {A_in.shape[0]} associations "
          f"(score {float(soln.score):.3f}, {int(soln.ifinal)} outer iters):")
    print(A_in)
    assert A_in.shape[0] == 3, A_in

    # recover the transform data -> model from the selected correspondences
    P = data.T[A_in[:, 1]]
    Q = model.T[A_in[:, 0]]
    R, t = kabsch_se3(torch.as_tensor(P, device=dev),
                      torch.as_tensor(Q, device=dev))
    rmse = float(transform_rmse(P, Q, R, t))
    R, t = R.cpu().numpy(), t.cpu().numpy()
    rot_err = np.rad2deg(np.arccos(np.clip((np.trace(R.T @ R_true) - 1) / 2,
                                           -1, 1)))
    t_err = np.linalg.norm(t - t_true)
    print(f"recovered rotation error: {rot_err:.4f} deg, "
          f"translation error: {t_err:.6f}, rmse {rmse:.2e}")
    assert rot_err < 1e-4 and t_err < 1e-6 and rmse < 1e-6
    return A_in, R, t


if __name__ == "__main__":
    main()
