from .base import Dynamics, make_dynamics, registered_models
from .integrators import euler_step, make_step, midpoint_step, rk4_step
from .arm import (LinkSpec, arm_constants, make_mahi_arm, make_serial_arm,
                  make_two_link_arm)
from .pendulum import make_cartpole, make_pendulum
from .double_pendulum import make_acrobot, make_double_pendulum

__all__ = [
    "Dynamics", "make_dynamics", "registered_models",
    "euler_step", "midpoint_step", "rk4_step", "make_step",
    "LinkSpec", "arm_constants", "make_serial_arm", "make_two_link_arm",
    "make_mahi_arm", "make_pendulum", "make_cartpole",
    "make_double_pendulum", "make_acrobot",
]
