"""Example 3: plane-cloud registration from two LiDAR scans.

Counterpart of ``examples/ex3_plane_cloud.py`` (reference:
examples/matlab/ex3_planecloud.m): plane parameters (unit normal; offset)
segmented from two real LiDAR scans with <50% overlap. The point-normal
invariant scores normals-only consistency (plane parameters as
point-normal data with zero points, reference: ex3_planecloud.m:84-86);
alignment is recovered by SVD on the matched normals plus a least-squares
translation from the offsets (reference: ex3_planecloud.m:100-115).

Run: python -m clipper_tpu_torch.examples.ex3_plane_cloud
         [--device=cuda|cpu]
"""

import numpy as np
import torch

import clipper_tpu_torch as ct
from clipper_tpu_torch.bench import harness

# plane parameters [nx ny nz d] per row (reference: ex3_planecloud.m:18-30)
D1 = np.array([
    [0.99778409, -0.02919371, -0.05978833, 1.84071578],
    [0.00655776, -0.34994794, 0.93674619, 5.81443529],
    [0.03067185, 0.93082657, 0.36417186, -22.82330860],
    [-0.03095734, 0.91232313, 0.40829902, -24.11912204],
])
D2 = np.array([
    [-0.07169808126, 0.855164861, 0.513373592, -28.65209536],
    [0.99514624580, 0.078913239, 0.058793283, -21.00096958],
    [-0.00156293830, -0.344498312, 0.938785636, 5.98810865],
    [0.08368147539, -0.930524190, -0.356541920, 29.41486128],
])
# ground-truth associations, 0-based (reference: ex3_planecloud.m:33, 1-based)
AGT = np.array([[0, 3], [1, 2], [2, 1]])


def main(argv=None):
    _, opts = harness.parse_argv(argv)
    dev = harness.bench_device(opts)
    # point-normal data: zero points, plane normals
    DD1 = np.concatenate([np.zeros((4, 3)), D1[:, :3]], axis=1).T  # (6, 4)
    DD2 = np.concatenate([np.zeros((4, 3)), D2[:, :3]], axis=1).T

    inv = ct.PointNormalDistance(ct.PointNormalDistanceParams(
        sign=float(np.deg2rad(1.5)), epsn=1.0))
    clipper = ct.Clipper(inv, ct.Params(), dtype=torch.float64, device=dev)
    clipper.score_pairwise_consistency(DD1, DD2)  # all-to-all
    # This scene has a near-symmetric second 3-clique (total weight 2.467
    # against the GT clique's 2.515); the local solver lands on either
    # depending on the init, a caveat the reference example carries
    # ("check for symmetries in input data", ex3_planecloud.m:95-98). A
    # fixed generator keeps this deterministic.
    clipper.solve(generator=torch.Generator().manual_seed(1))
    A_in = clipper.get_selected_associations()
    print("selected associations:\n", A_in)

    found = {tuple(r) for r in A_in.tolist()}
    expected = {tuple(r) for r in AGT.tolist()}
    assert found == expected, f"wrong correspondences: {found} vs {expected}"

    # alignment: rotation from matched normals, translation from offsets
    N1 = D1[A_in[:, 0], :3].T
    N2 = D2[A_in[:, 1], :3].T
    U, _, Vt = np.linalg.svd(N2 @ N1.T)
    R = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    N = (R @ N1).T
    d_diff = D1[A_in[:, 0], 3] - D2[A_in[:, 1], 3]
    t = np.linalg.solve(N.T @ N, N.T @ d_diff)
    print("recovered rotation:\n", np.round(R, 4))
    print("recovered translation:", np.round(t, 3))

    # residual check: transformed D1 normals should match D2 normals
    resid = np.linalg.norm(R @ N1 - N2)
    print("normal alignment residual:", f"{resid:.4f}")
    assert resid < 0.05
    return A_in, R, t


if __name__ == "__main__":
    main()
