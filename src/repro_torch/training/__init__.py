from . import faults
from .faults import FaultPlan, SimulatedKill, parse_faults, resolve_plan
from .resilience import (GuardPolicy, GuardState, guard_step, guard_verdict,
                         guarded_select, init_guard_state, inject_grad_faults)
from .serving import (ServeState, greedy_generate, make_decode_step,
                      make_prefill_step)
from .trainer import (TrainState, init_state, make_eval_step,
                      make_train_step, value_and_grad)

__all__ = ["FaultPlan", "GuardPolicy", "GuardState", "ServeState",
           "SimulatedKill", "TrainState", "faults", "greedy_generate",
           "guard_step", "guard_verdict", "guarded_select", "init_guard_state",
           "init_state", "inject_grad_faults", "make_decode_step",
           "make_eval_step", "make_prefill_step", "make_train_step",
           "parse_faults", "resolve_plan", "value_and_grad"]
