from diffphycon_tpu_torch.baselines.mpc_jellyfish import mpc_plan, mpc_receding_horizon
from diffphycon_tpu_torch.baselines.pid_burgers import PIDController, pid_control
from diffphycon_tpu_torch.baselines.sl_burgers import sl_optimize_control

__all__ = ["PIDController", "mpc_plan", "mpc_receding_horizon", "pid_control",
           "sl_optimize_control"]
