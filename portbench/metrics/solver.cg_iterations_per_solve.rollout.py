"""K4's CG iterations per element solved in the traced window: the program's
work counters ``solver.cg_iterations`` / ``solver.cg_solves``
(``diffphycon_tpu_torch.kernels.counters()``), which count only while a
profiler records."""

from portbench.yardstick import device_trace


def read(run):
    if device_trace(run, "rollout") is None or run.mode != "program":
        return None
    from diffphycon_tpu_torch import kernels

    counters = getattr(kernels, "counters", dict)()
    solves = counters.get("solver.cg_solves")
    return counters["solver.cg_iterations"] / solves if solves else None
