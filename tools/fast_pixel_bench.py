"""Measure fast pixel-PPO (grid-observation CNN) full-loop throughput.

Times N-update dispatches of train_many_pixel, warm, median of 5.

  python tools/fast_pixel_bench.py [ENVS] [N_UPDATES] [preset|default]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
N = int(sys.argv[2]) if len(sys.argv) > 2 else 8

import jax  # noqa: E402

from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

from gym_craftingworld_tpu import ray_config  # noqa: E402
from gym_craftingworld_tpu.train import fast_pixel_ppo as fpx  # noqa: E402

cfg = ray_config()
ppo = (fpx.PixelPPOConfig.throughput()
       if len(sys.argv) > 3 and sys.argv[3] == "preset"
       else fpx.PixelPPOConfig())
key = jax.random.PRNGKey(0)
ts = fpx.init_pixel_train_state(key, cfg, ppo)
env = fpx.fresh_packed_batch(cfg, jax.random.fold_in(key, 1), B)


def run(ts, env, key, n):
    t0 = time.time()
    ts, env, key, metrics = fpx.train_many_pixel(cfg, ppo, ts, env, n, key)
    float(metrics["loss"][-1])  # host sync
    return time.time() - t0, ts, env, key


_, ts, env, key = run(ts, env, key, N)  # compile + warm

steps_per_update = B * ppo.rollout_steps
times = []
for i in range(5):
    t, ts, env, key = run(ts, env, key, N)
    times.append(t)
times.sort()
dt = times[len(times) // 2]
rate = steps_per_update * N / dt
print(f"envs={B} rollout_steps={ppo.rollout_steps} "
      f"conv=({ppo.conv1},{ppo.conv2}) hidden={ppo.hidden}")
print(f"median of 5: {dt:.3f}s for {N} updates -> ms/update={1000*dt/N:.1f}")
print(f"pixel full-loop env-steps/s = {rate:.3e}")
