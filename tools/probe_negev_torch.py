"""Can negative visibility evidence pick the single-tag planar PnP branch?
On the port (port of ``tools/probe_negev.py``).

The ATE probe (``tools/probe_ate_dist_torch.py``) splits the headline RMSE
by visible tags; in the JAX package's run its tail was about 10 frames
with exactly one visible mapped tag, where both IPPE branches fit the 4
corners nearly equally. The branches still differ in what they imply: the
wrong one often puts other mapped landmarks squarely in view, landmarks
that were not detected. For every frame of the headline run this probe
solves both branches (``pose/pnp.solve_planar_pnp_dual``), refines each
against the final map with the joint Gauss-Newton (6 iterations), counts
each one's contradictions (active landmarks it implies were clearly
visible but were not detected), and compares the RMSE of the pick by
reprojection RMS with the pick by contradictions where the RMS values are
close. An analysis only: nothing of the pipeline changes. Prints the
three RMSEs, the frames where the picks differ, how often the right branch
carries a contradiction, the 12 worst frames, and one
``{"negev": {...}}`` line.

    python3 tools/probe_negev_torch.py                # on the card; exits 1 without one
    python3 tools/probe_negev_torch.py --device cpu --frames 16 --res 384
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from probe_ate_dist_torch import device_args, frame_errors, headline_run, rmse, run_header  # noqa: E402


def contradictions(T_wc, seen, lm_pose, lm_active, K, tag_size: float, W: int, H: int, min_side_px=22.0,
                   margin=0.10, z_min=1.0, facing_min=0.35) -> torch.Tensor:
    """(N,) count of active landmarks that camera poses ``T_wc`` (N, 4, 4)
    imply should have been clearly detected (in front, inside the image by
    ``margin``, at least ``min_side_px`` across, facing the camera) but are
    not in ``seen`` (N, M)."""
    from aprilslam_tpu_torch.geometry import se3_inverse

    T_cw = se3_inverse(T_wc)
    Xc = torch.einsum("nij,mj->nmi", T_cw[:, :3, :3], lm_pose[:, :3, 3]) + T_cw[:, None, :3, 3]
    z = Xc[..., 2]
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    f = K[0, 0]
    u = f * Xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / zs + K[1, 2]
    side = f * tag_size / zs.clamp(min=1e-6)
    mx, my = margin * W, margin * H
    inside = (u > mx) & (u < W - mx) & (v > my) & (v < H - my)
    n_c = torch.einsum("nij,mj->nmi", T_cw[:, :3, :3], lm_pose[:, :3, 2])
    ray = Xc / Xc.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    facing = (n_c * ray).sum(-1).abs()
    expected = lm_active & (z > z_min) & inside & (side > min_side_px) & (facing > facing_min)
    return (expected & ~seen).sum(-1)


def branches(cfg, cam, o: dict, ba_state) -> dict:
    """Both IPPE branches of every frame, in one batch on the BA state's
    device, from the step's outputs ``o`` (numpy, by ``outputs_numpy``'s
    fields) and its final BA state: for branch ``a`` and ``b`` the pose in
    the frame's coordinate tag's frame after the joint Gauss-Newton
    (``T_a``), its reprojection RMS (``r_a``) and its contradictions
    (``c_a``), as numpy."""
    from aprilslam_tpu_torch.geometry import se3_inverse
    from aprilslam_tpu_torch.pose.pnp import solve_planar_pnp_dual
    from aprilslam_tpu_torch.slam.localize import joint_camera_pose
    from aprilslam_tpu_torch.slam.pipeline import scatter_frame

    lm_pose, lm_active = ba_state.lm_pose, ba_state.lm_active
    dev, Ml = lm_pose.device, ba_state.n_landmarks
    K = torch.as_tensor(cam.matrix, dtype=torch.float32, device=dev)
    tag_size = cfg.tag_size_inner
    ids = torch.as_tensor(o["det_ids"], device=dev)
    ok = torch.as_tensor(o["det_ok"], device=dev)
    corners = torch.as_tensor(o["det_corners"], device=dev)
    N = ids.shape[0]

    res = solve_planar_pnp_dual(corners, K, tag_size, iters=3)
    corn_m, seen = scatter_frame(ids, ok, corners, Ml)
    use = seen & lm_active
    idsc = ids.clamp(0, Ml - 1).long()
    cand = ok & (ids >= 0) & (ids < Ml) & lm_active[idsc]
    c_idx = torch.argmin(torch.where(cand, ids, 2**30), dim=-1)
    c_id = idsc.gather(1, c_idx[:, None])[:, 0]
    T_lm = torch.where(lm_active[c_id][:, None, None], lm_pose[c_id], torch.eye(4, device=dev))
    rows = torch.arange(N, device=dev)
    T_wco = lm_pose[torch.as_tensor(o["coord_id"], device=dev).clamp(0, Ml - 1).long()]
    out = {}
    for b, T_tag in (("a", res.T[rows, c_idx]), ("b", res.T_alt[rows, c_idx])):
        T, r = joint_camera_pose(lm_pose, use, corn_m, K, tag_size, T_lm @ se3_inverse(T_tag), iters=6)
        c = contradictions(T, seen, lm_pose, lm_active, K, tag_size, cam.width, cam.height)
        out |= {f"T_{b}": (se3_inverse(T_wco) @ T).cpu().numpy(), f"r_{b}": r.cpu().numpy(),
                f"c_{b}": c.cpu().numpy()}
    return out


def summarize(cfg, traj, o: dict, br: dict) -> dict:
    """The JAX probe's numbers from the step's outputs ``o`` and the
    branches ``br`` (``branches``' fields)."""
    err_rep, v, gt = frame_errors(cfg, traj, o)
    r_a, c_a, r_b, c_b = br["r_a"], br["c_a"], br["r_b"], br["c_b"]
    e_a = np.linalg.norm(br["T_a"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    e_b = np.linalg.norm(br["T_b"][:, :3, 3] - gt[:, :3, 3], axis=-1)
    pick_rms = r_a <= r_b
    close = np.abs(r_a - r_b) < 0.5 * np.maximum(r_a, r_b)
    pick_neg = np.where(close & (c_a != c_b), c_a < c_b, pick_rms)
    err_rms = np.where(pick_rms, e_a, e_b)
    err_neg = np.where(pick_neg, e_a, e_b)
    nvis = o["n_visible"]

    def row(i):
        return [int(i), int(nvis[i]), float(r_a[i]), float(r_b[i]), int(c_a[i]), int(c_b[i]), float(e_a[i]),
                float(e_b[i])]

    changed = [row(i) + [bool((e_a[i] < e_b[i]) == pick_neg[i])] for i in np.flatnonzero(v & (pick_rms != pick_neg))]
    right_with_c = int(np.sum(v & (((e_a < e_b) & (c_a > 0)) | ((e_b < e_a) & (c_b > 0)))))
    return {
        "reported_rmse": rmse(err_rep, v), "rms_pick_rmse": rmse(err_rms, v), "negev_pick_rmse": rmse(err_neg, v),
        "changed": changed, "right_branch_with_contradictions": right_with_c, "scored": int(v.sum()),
        "worst": [row(i) for i in np.argsort(err_rms * v)[::-1][:12] if v[i]],
    }


def negev(cfg, cam, traj, o: dict, ba_state) -> dict:
    """``summarize`` of ``branches``."""
    return summarize(cfg, traj, o, branches(cfg, cam, o, ba_state))


def print_negev(d: dict) -> None:
    """The JAX probe's lines."""
    print(f"reported-pipeline  rmse={d['reported_rmse']:.4f}")
    print(f"rms-pick (probe)   rmse={d['rms_pick_rmse']:.4f}")
    print(f"negev-pick (probe) rmse={d['negev_pick_rmse']:.4f}")
    print(f"\npick changed on {len(d['changed'])} frames:")
    for i, nv, ra, rb, ca, cb, ea, eb, right in d["changed"]:
        print(f"  f{i:3d} nvis={nv} rms a/b={ra:6.2f}/{rb:6.2f} c a/b={ca}/{cb} err a/b={ea:6.3f}/{eb:6.3f} "
              f"negev-{'RIGHT' if right else 'WRONG'}")
    print(f"\ncorrect-branch-with-contradictions frames: {d['right_branch_with_contradictions']}/{d['scored']}")
    print("\nworst frames under rms-pick:")
    for i, nv, ra, rb, ca, cb, ea, eb in d["worst"]:
        print(f"  f{i:3d} nvis={nv} rms a/b={ra:6.2f}/{rb:6.2f} c a/b={ca}/{cb} err a/b={ea:6.3f}/{eb:6.3f}")


def main(argv=None) -> int:
    args = device_args(__doc__.split("\n\n")[0], argv)
    if args is None:
        return 1
    run = headline_run(args.device, args.frames, args.res)
    head = run_header(run, args.device)
    d = negev(run["cfg"], run["cam"], run["traj"], run["outputs"], run["ba_state"])
    print_negev(d)
    print(json.dumps({"negev": {**head, **d}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
