#!/usr/bin/env python
"""Guided inference / control evaluation for the jellyfish benchmark on the
GPU.

Port of ``apps/infer_jellyfish.py`` (DDPM and DDIM): loads the joint (7 -> 4
channels) and thetas (7 -> 1) UNet3Ds from the port's checkpoints
(``apps/train_jellyfish.py``), the ForceUNet and the boundary updater from
the surrogate folder (``apps/train_surrogates_jellyfish.py``), samples with
the boundary updater inside the loop and force guidance, and reports the
control objective (time-weighted mean thrust - reg * sum dtheta^2) of the
sampled plan through the force surrogate, and the closed-loop objective of
its theta schedule executed through the surrogate pipeline. The scoring
pipeline may come from a disjoint split (``--score_surrogate_folder``), so
that guidance cannot inflate the score by exploiting the nets that compute
it. Writes ``results.json`` (appended) and ``pred_thetas_seed<seed>.npy``;
``--rescore_thetas`` scores saved schedules without sampling.

``--inference_method MPC`` runs the receding-horizon MPC baseline through
the surrogate pipeline instead (``baselines/mpc_jellyfish.py``; no diffusion
checkpoint needed) and appends its objective and walltime to the same
``results.json``; ``MPC_LBFGS`` replans with L-BFGS and its zoom line search
(``baselines/lbfgs.py``) instead of Adam.
``--scan_chunks`` is accepted and has no effect: the sampler is a Python
loop.

Example:
  python -m diffphycon_tpu_torch.apps.infer_jellyfish --dataset_path data/jellyfish \\
      --joint_folder trained_models/jellyfish --w_folder trained_models/jellyfish_w \\
      --surrogate_folder trained_models/surrogates
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="Jellyfish guided inference (PyTorch/CUDA)")
    p.add_argument("--dataset_path", default="data/jellyfish", type=str)
    p.add_argument("--n_test_samples", default=8, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--joint_folder", default="trained_models/jellyfish")
    p.add_argument("--w_folder", default="trained_models/jellyfish_w")
    p.add_argument("--surrogate_folder", default="trained_models/surrogates")
    p.add_argument("--score_surrogate_folder", default=None,
                   help="surrogates for the closed-loop scoring only (guidance keeps "
                        "--surrogate_folder)")
    p.add_argument("--rescore_thetas", default=None,
                   help="npy of (N, F) saved pred thetas: skip sampling and only "
                        "closed-loop score them")
    p.add_argument("--diffusion_joint_checkpoint", default=1, type=int)
    p.add_argument("--diffusion_w_checkpoint", default=1, type=int)
    p.add_argument("--use_ema", default=True, type=eval)
    p.add_argument("--inference_result_path", default="jellyfish_results")

    p.add_argument("--frames", default=20, type=int)
    p.add_argument("--cond_steps", default=1, type=int)
    p.add_argument("--only_vis_pressure", default=False, type=eval)
    p.add_argument("--sampling_timesteps", default=1000, type=int)
    p.add_argument("--timesteps", default=1000, type=int)
    p.add_argument("--w_prob_exp", default=1.0, type=float)
    p.add_argument("--standard_fixed_ratio", default=0.01, type=float)
    p.add_argument("--coeff_ratio_J", default=0.3, type=float)
    p.add_argument("--coeff_ratio_w", default=0.3, type=float)
    p.add_argument("--design_guidance", default="standard", type=str)
    p.add_argument("--use_guidance_in_model_predictions", default=False, type=eval)
    p.add_argument("--reg_ratio", default=0.0, type=float)
    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--dim_mults", nargs="+", default=[1, 2, 4], type=int)
    p.add_argument("--bf16", default=False, type=eval)
    p.add_argument("--inference_method", default="DDPM", choices=["DDPM", "MPC", "MPC_LBFGS"],
                   help="MPC / MPC_LBFGS: receding-horizon replanning through the surrogate "
                        "pipeline with Adam / L-BFGS")
    p.add_argument("--num_iters", default=30, type=int, help="MPC replanning iterations")
    p.add_argument("--coef_grad", default=0.05, type=float, help="MPC step size")
    p.add_argument("--lamda", default=1000.0, type=float, help="MPC theta-smoothness weight")
    p.add_argument("--coef_endcondition", default=0.0, type=float)
    p.add_argument("--coef_clip", default=0.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--scan_chunks", default=1, type=int,
                   help="accepted for the JAX app's command lines; no effect here")
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def _surrogates(bench, cfg, folder, device):
    from diffphycon_tpu_torch.training.surrogates import load_surrogate

    return (load_surrogate(folder, "simulator", bench.build_simulator_unet(cfg, device=device),
                           device),
            load_surrogate(folder, "force", bench.build_force_unet(cfg, device=device), device),
            load_surrogate(folder, "boundary_updater", bench.build_bd_updater(cfg, device=device),
                           device))


def _diffusion_net(build, cfg, folder, milestone, use_ema, device):
    from diffphycon_tpu_torch.training.trainer import Trainer

    net = build(cfg, device=device)
    net.load_state_dict(Trainer.load_params(folder, milestone, use_ema=use_ema))
    return net


def run_mpc(args, cfg, device):
    """Receding-horizon MPC (Adam, or L-BFGS for MPC_LBFGS) through the
    surrogate pipeline, batch by batch; appends {"args", "metrics"} to
    results.json and returns the metrics (the JAX app's row: method,
    objective, walltime, n)."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.baselines.mpc_jellyfish import mpc_receding_horizon
    from diffphycon_tpu_torch.benchmarks import jellyfish as bench
    from diffphycon_tpu_torch.control.metrics import jellyfish_objective
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset

    data = load_jellyfish_dataset(args.dataset_path, "test", n=args.n_test_samples,
                                  only_vis_pressure=args.only_vis_pressure)
    ppl = bench.SurrogatePipeline(cfg, *_surrogates(bench, cfg, args.surrogate_folder, device),
                                  p_min=float(data["norm"]["p_min"]),
                                  p_max=float(data["norm"]["p_max"]))
    n = data["states"].shape[0]
    bs = min(args.batch_size, n)
    rows = []
    t0 = time.time()
    for i in range(0, n, bs):
        s0, b0, th0 = (torch.as_tensor(data[k][i : i + bs, 0], device=device)
                       for k in ("states", "bd", "thetas"))
        thetas, _, forces = mpc_receding_horizon(
            ppl, s0, b0, th0, frames=cfg.frames, num_iters=args.num_iters, lr=args.coef_grad,
            lamda=args.lamda, coef_endcondition=args.coef_endcondition,
            coef_clip=args.coef_clip, seed=args.seed + i,
            optimizer="lbfgs" if args.inference_method == "MPC_LBFGS" else "adam")
        rows.append(jellyfish_objective(forces, thetas[:, 1:] - thetas[:, :-1],
                                        args.reg_ratio).cpu().numpy())
        print(f"batch {i // bs}: J={rows[-1].mean():.4f}", flush=True)
    agg = {"method": args.inference_method,
           "objective": float(np.concatenate(rows).mean()),
           "walltime_s": round(time.time() - t0, 2), "n": n}
    os.makedirs(args.inference_result_path, exist_ok=True)
    with open(os.path.join(args.inference_result_path, "results.json"), "a") as fh:
        fh.write(json.dumps({"args": vars(args), "metrics": agg}) + "\n")
    print("MPC objective =", agg["objective"], "walltime:", agg["walltime_s"], flush=True)
    return agg


def main(args):
    """Sample, score and write the results; returns the aggregate dict."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.benchmarks import jellyfish as bench
    from diffphycon_tpu_torch.control.metrics import jellyfish_objective
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset

    device = resolve_device(args.device)
    cfg = bench.JellyfishConfig(
        dim=args.dim, dim_mults=tuple(args.dim_mults), frames=args.frames,
        cond_steps=args.cond_steps, only_vis_pressure=args.only_vis_pressure,
        timesteps=args.timesteps, sampling_timesteps=args.sampling_timesteps,
        w_prob_exp=args.w_prob_exp, standard_fixed_ratio=args.standard_fixed_ratio,
        coeff_ratio_J=args.coeff_ratio_J, coeff_ratio_w=args.coeff_ratio_w,
        design_guidance=args.design_guidance,
        use_guidance_in_model_predictions=args.use_guidance_in_model_predictions,
        reg_ratio=args.reg_ratio, bf16=args.bf16)
    if args.inference_method in ("MPC", "MPC_LBFGS"):
        return run_mpc(args, cfg, device)
    data = load_jellyfish_dataset(args.dataset_path, "test", n=args.n_test_samples,
                                  only_vis_pressure=args.only_vis_pressure)
    p_min, p_max = float(data["norm"]["p_min"]), float(data["norm"]["p_max"])
    saved_thetas = np.load(args.rescore_thetas) if args.rescore_thetas else None

    _, net_force, net_bd = _surrogates(bench, cfg, args.surrogate_folder, device)
    # closed-loop scoring may use a DISJOINT surrogate pipeline
    sim_sc, force_sc, bd_sc = _surrogates(
        bench, cfg, args.score_surrogate_folder or args.surrogate_folder, device)
    pipeline = bench.SurrogatePipeline(cfg, sim_sc, force_sc, bd_sc, p_min=p_min, p_max=p_max)
    if saved_thetas is None:
        net_joint = _diffusion_net(bench.build_joint_unet, cfg, args.joint_folder,
                                   args.diffusion_joint_checkpoint, args.use_ema, device)
        net_thetas = _diffusion_net(bench.build_thetas_unet, cfg, args.w_folder,
                                    args.diffusion_w_checkpoint, args.use_ema, device)
        gd = bench.JellyfishDiffusion(cfg, net_joint, thetas_model=net_thetas,
                                      bd_updater=net_bd, device=device)
        design_fn = bench.make_force_design_fn(cfg, net_force, net_bd, p_min, p_max)

    @torch.no_grad()
    def objective(pred_states, pred_theta, b0):
        """The guidance objective of the sampled plan, all B * F frames in
        one pass (the bd-updater input is theta itself, as in the JAX app)."""
        b, f, h, w, _ = pred_states.shape
        pressure = (0.5 * pred_states[..., cfg.n_state - 1] + 0.5) * (p_max - p_min) + p_min
        bd_t = net_bd(b0[:, None].expand(b, f, h, w, 3).reshape(b * f, h, w, 3),
                      pred_theta.reshape(b * f))
        inp = torch.cat([pressure.reshape(b * f, h, w, 1), bd_t], dim=-1)
        force = net_force(inp)[:, 0].reshape(b, f)
        return jellyfish_objective(force, pred_theta[:, 1:] - pred_theta[:, :-1],
                                   args.reg_ratio)

    n = data["states"].shape[0]
    bs = min(args.batch_size, n)
    all_obj, all_obj_cl, all_theta_mae, all_pred_theta = [], [], [], []
    sample_s = rollout_s = 0.0
    t0 = time.time()
    for i in range(0, n, bs):
        s0, b0, th0 = (torch.as_tensor(data[k][i : i + bs, 0], device=device)
                       for k in ("states", "bd", "thetas"))
        th_gt = data["thetas"][i : i + bs, : cfg.frames]
        tic = time.perf_counter()
        if saved_thetas is not None:
            pred_theta = torch.as_tensor(saved_thetas[i : i + bs], device=device)
            obj = torch.zeros(pred_theta.shape[0])
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed + i)
            pred_states, pred_theta = gd.sample(s0, b0, th0, design_fn=design_fn,
                                                generator=gen)
            obj = objective(pred_states, pred_theta, b0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sample_s += time.perf_counter() - tic
        tic = time.perf_counter()
        with torch.no_grad():
            _, forces_cl = pipeline.rollout(s0, b0, pred_theta)
            obj_cl = jellyfish_objective(forces_cl, pred_theta[:, 1:] - pred_theta[:, :-1],
                                         args.reg_ratio)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rollout_s += time.perf_counter() - tic
        pt = pred_theta.cpu().numpy()
        all_pred_theta.append(pt)
        all_obj.append(obj.cpu().numpy())
        all_obj_cl.append(obj_cl.cpu().numpy())
        all_theta_mae.append(np.abs(pt - th_gt).mean(axis=1))
        print(f"batch {i // bs}: objective={float(all_obj[-1].mean()):.4f} "
              f"closed_loop={float(all_obj_cl[-1].mean()):.4f}", flush=True)
    agg = {
        # no open-loop objective is computed when rescoring: None, not 0.0
        "objective": None if saved_thetas is not None else float(np.concatenate(all_obj).mean()),
        "objective_closed_loop": float(np.concatenate(all_obj_cl).mean()),
        "theta_mae_vs_gt": float(np.concatenate(all_theta_mae).mean()),
        "walltime_s": round(time.time() - t0, 2),
        "sampling_s": round(sample_s, 3),
        "rollout_s": round(rollout_s, 3),
        "n": n,
    }
    os.makedirs(args.inference_result_path, exist_ok=True)
    if saved_thetas is None:
        np.save(os.path.join(args.inference_result_path, f"pred_thetas_seed{args.seed}.npy"),
                np.concatenate(all_pred_theta, 0))
    with open(os.path.join(args.inference_result_path, "results.json"), "a") as fh:
        fh.write(json.dumps({"args": vars(args), "metrics": agg}) + "\n")
    print("objective =", agg["objective"], "walltime:", agg["walltime_s"], flush=True)
    return agg


if __name__ == "__main__":
    main(build_parser().parse_args())
