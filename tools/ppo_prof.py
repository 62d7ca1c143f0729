import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from gym_craftingworld_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()
import jax.numpy as jnp
from functools import partial

from gym_craftingworld_tpu import flat_config, reset_from_seed
from gym_craftingworld_tpu.core.reset import _reset_one
from gym_craftingworld_tpu.core.step import _step_one
from gym_craftingworld_tpu.train import ppo as P

B = int(os.environ.get("B", 4096))
cfg = flat_config()
ppo = P.PPOConfig()
key = jax.random.PRNGKey(0)
ts = P.init_train_state(key, cfg, ppo)
env_state = reset_from_seed(cfg, 0, B)

def timeit(name, fn, *args, n=7):
    float(fn(*args))  # warm
    ts_ = []
    for _ in range(n):
        t0 = time.time()
        float(fn(*args))
        ts_.append(time.time() - t0)
    ts_.sort()
    print(f"{name}: {ts_[len(ts_)//2]*1e3:.1f}ms")

# full train step (non-donating copy for repeat timing)
ts1, env1, key1, metrics = P.train_step(cfg, ppo, ts, env_state, key)
float(metrics["loss"])
times = []
for _ in range(7):
    t0 = time.time()
    ts1, env1, key1, metrics = P.train_step(cfg, ppo, ts1, env1, key1)
    float(metrics["loss"])
    times.append(time.time() - t0)
times.sort()
full = times[len(times)//2]
print(f"train_step full: {full*1e3:.1f}ms -> {B*ppo.rollout_steps/full/1e3:.0f}k env-steps/s")

_, apply_fn = P.make_policy(ppo)

@jax.jit
def collect_only(params, st, k):
    st, traj = P._collect(cfg, ppo, apply_fn, params, st, k)
    return traj.reward.sum()

st = reset_from_seed(cfg, 1, B)
timeit("collect (64 steps)", collect_only, ts1.params, st, key)

@jax.jit
def resets_only(k):
    def body(c, _):
        ks = jax.random.split(c, B)
        fresh = jax.vmap(partial(_reset_one, cfg))(ks)
        return ks[0], fresh.objects.astype(jnp.int32).sum()
    _, s = jax.lax.scan(body, k, None, length=64)
    return s.sum()
timeit("64x vmapped reset", resets_only, key)

@jax.jit
def steps_only(st, k):
    def body(c, _):
        s, kk = c
        kk, ka = jax.random.split(kk)
        a = jax.random.randint(ka, (B,), 0, 6)
        s, res = jax.vmap(partial(_step_one, cfg))(s, a)
        return (s, kk), res.reward.sum()
    (st, _), s = jax.lax.scan(body, (st, k), None, length=64)
    return s.sum()
st = reset_from_seed(cfg, 2, B)
timeit("64x grid step", steps_only, st, key)

@jax.jit
def fwd_only(params, st, k):
    snap = P.snapshot(st)
    def body(c, _):
        logits, value = apply_fn(params, snap)
        return c + logits.sum() + value.sum(), None
    s, _ = jax.lax.scan(body, jnp.float32(0), None, length=64)
    return s
timeit("64x policy fwd", fwd_only, ts1.params, st, key)

@jax.jit
def update_only(params, opt_state, st, k):
    # one epoch of minibatch updates on a synthetic flat batch
    import optax
    from gym_craftingworld_tpu.train.ppo import _ppo_loss, make_optimizer
    T = ppo.rollout_steps
    snap = P.snapshot(st)
    flatsnap = jax.tree.map(lambda x: jnp.tile(x, (T,) + (1,)*(x.ndim-1)), snap)
    n = T * B
    action = jnp.zeros((n,), jnp.int32)
    lp = jnp.zeros((n,), jnp.float32); v = jnp.zeros((n,), jnp.float32)
    adv = jnp.ones((n,), jnp.float32); ret = jnp.ones((n,), jnp.float32)
    flat = (flatsnap, action, lp, v, adv, ret)
    optimizer = make_optimizer(ppo)
    perm = jax.random.permutation(k, n)
    mb = n // ppo.num_minibatches
    def minibatch(carry, i):
        params, opt_state = carry
        idx = jax.lax.dynamic_slice_in_dim(perm, i * mb, mb)
        batch = tuple(jax.tree.map(lambda x: x[idx], x) for x in flat)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: _ppo_loss(ppo, apply_fn, p, batch), has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax as ox
        params = ox.apply_updates(params, updates)
        return (params, opt_state), loss
    (params, opt_state), losses = jax.lax.scan(
        minibatch, (params, opt_state), jnp.arange(ppo.num_minibatches))
    return losses.sum()
timeit("1 epoch updates (4 minibatches)", update_only, ts1.params, ts1.opt_state, st, key)
