"""Tiny CPU versions of the cells: the same drivers, systems and checks at
widths a test run holds."""

import time

from portbench import harness

TINY = {
    "burgers-guided-ddpm-b50": (
        {"dim": 8, "dim_mults": [1, 2], "nx": 32},
        {"batch": 2, "warm_steps": 1, "check_within": 4, "check_steps": 2, "trace_steps": 2}),
    "smoke-guided-ddim-b8": (
        {"dim": 8, "dim_mults": [1, 2], "frames": 4, "image_size": 16},
        {"batch": 2, "warm_steps": 1, "check_within": 3, "check_steps": 2, "trace_steps": 1}),
    "smoke-train-b16": (
        {"dim": 8, "dim_mults": [1, 2], "frames": 4, "image_size": 16},
        {"batch": 4, "batch_pool": 5, "trace_steps": 1, "reference_chunks": 2}),
    "smoke-rollout-b8": (
        {"frames": 4, "solver": {"domain": 128, "accuracy": 1e-06, "max_iterations": 500,
                                 "frames": 8, "initial_vy": 0.8}},
        {"batch": 2, "check_frames": 2}),
}


def tiny_run(name, seed=1234567890123, mode="program", trace=False, seconds=0.5, **cfg):
    cell = harness.load_cell(name)
    over_cfg, over_traffic = TINY[name]
    cell.cfg.update(over_cfg)
    cell.cfg.update(cfg)
    cell.traffic.update(over_traffic)
    cell.limits = TINY_LIMITS[name]
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                      t_start=time.perf_counter(), mode=mode)
    return run, harness.execute(run)


# Limits of the tiny CPU cells (their own: the widths differ from the cells'),
# set between the tiny program's readings and the tiny control's on seeds
# 1, 22, 333 and 4444 (bf16 plain versions against the float32 reference).
TINY_LIMITS = {
    "burgers-guided-ddpm-b50": {"step_rel_l2": 0.01, "joint_eps_rel_l2": 0.04,
                                "prior_eps_rel_l2": 0.045},
    "smoke-guided-ddim-b8": {"step_rel_l2": 0.01, "joint_eps_rel_l2": 0.05,
                             "prior_eps_rel_l2": 0.05},
    "smoke-train-b16": {"first_grad_leaf_gap": 0.1, "update_leaf_gap": 0.3},
    "smoke-rollout-b8": {"velocity_rel_l2": 0.01, "density_rel_l2": 0.01},
}
