from gym_craftingworld_tpu.ops.packed_fused import (
    action_stream,
    fused_rollout_packed_bench,
    rollout_layout,
    rollout_random_bench,
)
from gym_craftingworld_tpu.ops.packed_rollout import (
    rollout_p,
    rollout_p_bench,
    rollout_p_random,
)

__all__ = [
    "action_stream",
    "fused_rollout_packed_bench",
    "rollout_layout",
    "rollout_p",
    "rollout_p_bench",
    "rollout_p_random",
    "rollout_random_bench",
]
