"""Historical gym seed hashing (gym<=0.19) — scheme pinning + parity.

The reference's ``seed()`` routes through ``gym.utils.seeding.np_random``
(craftingworld_ray.py:145-147). Under 2019-era gym (0.9-0.19) that hashes the
seed with SHA-512 before constructing the RandomState; the bundled shim
implements that scheme as ``scheme="legacy_hash"`` (default remains
``direct``). These tests pin the hash algebra to golden values and re-prove
public-API episode parity with BOTH sides running the hashed scheme.
"""

import numpy as np
import pytest

from gym_craftingworld_tpu.parity import oracle, seeding


def test_hash_seed_golden_values():
    # goldens for the gym<=0.19 pipeline: sha512(str(seed))[:8] -> bigint
    assert seeding.hash_seed(0) == 1331072711323073585
    assert seeding.hash_seed(23) == 16791981298183107439
    assert seeding.hash_seed(42) == 7611020616111278649
    assert seeding._int_list_from_bigint(1331072711323073585) == [
        547404849, 309914516]


def test_np_random_legacy_hash_draws():
    rng, seed = seeding.np_random(42, scheme="legacy_hash")
    assert seed == 42
    assert [int(rng.randint(1000)) for _ in range(4)] == [75, 793, 109, 957]
    # hashed and direct schemes genuinely differ
    rng_d, _ = seeding.np_random(42, scheme="direct")
    assert int(rng_d.randint(1000)) != 75 or [
        int(rng_d.randint(1000)) for _ in range(3)] != [793, 109, 957]


def test_create_seed_normalisation():
    assert seeding.create_seed(2**70 + 5) == (2**70 + 5) % 2**64
    assert isinstance(seeding.create_seed("hello"), int)
    with pytest.raises(ValueError):
        seeding.np_random(-1)


@pytest.mark.skipif(
    not oracle.reference_available(), reason="reference checkout not present"
)
def test_public_api_episode_parity_under_legacy_hash(monkeypatch):
    """Bit-exact episode replay with the historical hashed seeding active."""
    monkeypatch.setenv("CW_GYMSHIM_SEEDING", "legacy_hash")
    from gym_craftingworld_tpu.api import CraftingWorldEnvOneHot

    seed = 17
    ref = oracle.make_reference_env("onehot", seed=seed)
    ours = CraftingWorldEnvOneHot(seed=seed, rng_mode="parity")
    ref_obs = ref.reset()
    our_obs = ours.reset()
    np.testing.assert_array_equal(
        our_obs["observation"].astype(np.int64),
        np.array(ref_obs["observation"]),
    )
    np.testing.assert_array_equal(
        our_obs["desired_goal"].astype(np.int64),
        np.array(ref_obs["desired_goal"]),
    )
    rng = np.random.RandomState(7)
    for t in range(120):
        a = int(rng.randint(6))
        r_obs, r_rew, r_done, r_info = ref.step(a)
        o_obs, o_rew, o_done, o_info = ours.step(a)
        assert o_rew == r_rew, f"step {t}"
        assert o_done == r_done, f"step {t}"
        np.testing.assert_array_equal(
            o_obs["observation"].astype(np.int64),
            np.array(r_obs["observation"]),
            err_msg=f"step {t}",
        )
        if r_done:
            break


@pytest.mark.skipif(
    not oracle.reference_available(), reason="reference checkout not present"
)
def test_hash_vs_direct_schemes_give_different_worlds(monkeypatch):
    """Same seed, different scheme → different reset (the hash matters)."""
    from gym_craftingworld_tpu.api import CraftingWorldEnvOneHot

    monkeypatch.setenv("CW_GYMSHIM_SEEDING", "direct")
    obs_d = CraftingWorldEnvOneHot(seed=3, rng_mode="parity").reset()
    monkeypatch.setenv("CW_GYMSHIM_SEEDING", "legacy_hash")
    obs_h = CraftingWorldEnvOneHot(seed=3, rng_mode="parity").reset()
    assert not np.array_equal(
        np.asarray(obs_d["observation"]), np.asarray(obs_h["observation"])
    )
