"""Measure fast-PPO full-loop throughput on the GPU.

Times train_many_fast (N updates in ONE dispatch), warm, ended with
block_until_ready.

  python tools/fast_ppo_bench.py [ENVS] [N_UPDATES] [preset|default]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
N = int(sys.argv[2]) if len(sys.argv) > 2 else 64

import jax  # noqa: E402

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

from gym_craftingworld_tpu import ray_config  # noqa: E402
from gym_craftingworld_tpu.train import fast_ppo as fp  # noqa: E402

cfg = ray_config()
fppo = (fp.FastPPOConfig.throughput()
        if len(sys.argv) > 3 and sys.argv[3] == "preset"
        else fp.FastPPOConfig())
key = jax.random.PRNGKey(0)
ts = fp.init_fast_train_state(key, cfg, fppo)
env = fp.fresh_packed_batch(cfg, jax.random.fold_in(key, 1), B)


def run(ts, env, key, n):
    t0 = time.time()
    ts, env, key, metrics = fp.train_many_fast(cfg, fppo, ts, env, n, key)
    float(metrics["loss"][-1])  # host sync
    return time.time() - t0, ts, env, key


# compile + warm
_, ts, env, key = run(ts, env, key, N)

steps_per_update = B * fppo.rollout_steps
times = []
for i in range(3):
    t, ts, env, key = run(ts, env, key, N)
    times.append(t)
best = min(times)
rate = steps_per_update * N / best
print(f"envs={B} rollout_steps={fppo.rollout_steps} hidden={fppo.hidden} "
      f"epochs={fppo.update_epochs} updates/dispatch={N}")
print(f"best of {len(times)}: {best:.3f}s  ms/update={1000*best/N:.1f}")
print(f"full-loop env-steps/s = {rate:.3e}")
