"""The simulator: obstacle fields, the expert, the quadrotor models, the
analytic renderer, closed-loop trials (one, or G in lockstep), the
evaluation runner, the RL environments and PPO; and the parts the
deployment path flies (``native_quad``, ``pilot``).

Port of ``evfly_tpu/sim``: the numpy-only modules are copies, the rest run
on one device (CUDA unless the caller passes ``device="cpu"``).  Importing
the package touches no device.
"""

from .obstacles import ObstacleField, generate_forest, load_obstacle_csv, save_obstacle_csv
from .expert import expert_velocity_command
from .dynamics import QuadState, VelocityTrackingQuad
from .rigid_body import QuadrotorParams, RigidBodyQuad
from .evaluator import TrialEvaluator
from .closed_loop import run_trial, rollout_to_trajectory
from .batched import BatchedQuads, run_trials_batched
from .planner import Planner, PlannerExpert
from .launch_evaluation import run_evaluation
from .vision_env import EnvParams, VecVisionEnv

__all__ = [
    "ObstacleField",
    "generate_forest",
    "load_obstacle_csv",
    "save_obstacle_csv",
    "expert_velocity_command",
    "QuadState",
    "VelocityTrackingQuad",
    "RigidBodyQuad",
    "QuadrotorParams",
    "TrialEvaluator",
    "run_trial",
    "rollout_to_trajectory",
    "run_trials_batched",
    "BatchedQuads",
    "Planner",
    "PlannerExpert",
    "run_evaluation",
    "EnvParams",
    "VecVisionEnv",
]
