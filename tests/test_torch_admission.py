"""The port's admission plane (tpu/admission.py) against the reference's.

In-process twins of tests/test_admission_plane.py's tier-1 tests: two
port engines in ONE process over the InProcKV double, the leader taking
live submits and the follower rebuilding every wave from the KV plane
alone. Then the two-process twin of tests/test_multihost_exec.py's live
traffic test: two spawned processes join one job through the JAX_* keys
(parallel/multihost.py, gloo over a TCPStore), each builds the paged
engine at tp=2 with a plane over the job's store (StoreKV), rank 0 takes
staggered submits and a mid-stream cancel, and rank 1's shadow streams
must equal the leader's token for token; the leader's uncancelled streams
must equal the JAX single-device engine's on the same weights.
"""

import time

import jax
import pytest

from gofr_tpu.models.llama import LlamaConfig as JConfig
from gofr_tpu.models.llama import llama_init as jax_init
from gofr_tpu.tpu.engine import LLMEngine as JEngine
from gofr_tpu_torch.models.llama import LlamaConfig
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.tpu.admission import AdmissionPlane, InProcKV, StoreKV
from gofr_tpu_torch.tpu.engine import LLMEngine

import torch_dist
import torch_dist_workers as workers

CFG = LlamaConfig(vocab_size=128, dim=32, n_layers=2, n_heads=2,
                  n_kv_heads=2, ffn_dim=64, max_seq_len=256, dtype="float32")
JCFG = JConfig(vocab_size=128, dim=32, n_layers=2, n_heads=2, n_kv_heads=2,
               ffn_dim=64, max_seq_len=256, dtype="float32")
ENGINE_KW = dict(n_slots=4, max_seq_len=64, prefill_buckets=(8,),
                 decode_block_size=4)


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


@pytest.fixture(scope="module")
def weights():
    """The reference's weights (llama_init seed 0), as numpy leaves."""
    return jax.device_get(jax_init(JCFG, seed=0))


def _engine(weights, plane=None, **overrides):
    kw = dict(ENGINE_KW, **overrides)
    return LLMEngine(params_from_numpy(weights, device="cpu"), CFG,
                     device="cpu", admission_plane=plane,
                     logger=_QuietLogger(), **kw)


def _pair(weights, kv, **overrides):
    leader_plane = AdmissionPlane(process_id=0, kv=kv)
    follower_plane = AdmissionPlane(process_id=1, kv=kv)
    shadows = []
    follower_plane.on_shadow = shadows.append
    leader = _engine(weights, leader_plane, **overrides)
    follower = _engine(weights, follower_plane, **overrides)
    return leader, follower, shadows


def _wait_shadows(shadows, n, timeout_s=120.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if len(shadows) >= n and all(
                s.finished_at is not None or s.error is not None
                for s in shadows):
            return
        time.sleep(0.02)
    raise AssertionError(
        f"follower mirrored {len(shadows)}/{n} shadows; "
        f"finished={[s.finished_at is not None for s in shadows]}")


def test_follower_rejects_local_submits(weights):
    follower = _engine(weights, AdmissionPlane(process_id=1, kv=InProcKV()))
    with pytest.raises(RuntimeError, match="leader"):
        follower.submit([1, 2, 3])


def test_cancel_takes_effect_on_the_same_wave_everywhere(weights):
    # a deep victim budget: the consumer thread that cancels can lag many
    # decode blocks behind the engine, and must still cut it short
    leader, follower, shadows = _pair(weights, InProcKV(), max_seq_len=200)
    follower.start()
    leader.start()
    try:
        victim = leader.submit([1, 2, 3], max_new_tokens=180,
                               temperature=0.0)
        survivor = leader.submit([9, 8], max_new_tokens=12, temperature=0.0)
        for _ in victim.stream(timeout_s=30):
            if victim.generated >= 6:
                victim.cancel()
                break
        list(victim.stream(timeout_s=60))
        assert victim.generated < 180  # actually cut short
        got_survivor = survivor.result(timeout_s=30)
        assert len(got_survivor) == 12  # unaffected by the peer cancel
        _wait_shadows(shadows, 2)
        by_id = {s.id: s for s in shadows}
        # the follower cut the shadow at the SAME token count: the cancel
        # rode a wave, not a rank-local event
        assert by_id[victim.id].generated == victim.generated
        assert list(by_id[survivor.id].stream(timeout_s=5)) == got_survivor
    finally:
        leader.stop()
        follower.stop()


def test_leader_stop_mid_generation_stops_follower(weights):
    """The stop sentinel arriving while the follower still has active
    slots must end that rank at the same wave."""
    leader, follower, shadows = _pair(weights, InProcKV())
    follower.start()
    leader.start()
    request = leader.submit([1], max_new_tokens=60, temperature=0.0)
    for _ in request.stream(timeout_s=30):
        break  # generation confirmed underway
    leader.stop()  # sentinel published with the shadow slot still active
    t0 = time.time()
    follower.stop()
    assert time.time() - t0 < 15  # loop exited; no wedged join
    _wait_shadows(shadows, 1, timeout_s=10)
    assert shadows[0].error is not None  # failed loudly, not stranded


def test_idle_engines_publish_no_waves(weights):
    kv = InProcKV()
    leader, follower, _ = _pair(weights, kv)
    follower.start()
    leader.start()
    try:
        leader.generate([1, 2, 3], max_new_tokens=4, temperature=0.0)
        time.sleep(0.3)  # both engines idle now
        before = len(kv._data)
        time.sleep(0.5)
        assert len(kv._data) == before  # no idle KV churn
    finally:
        leader.stop()
        follower.stop()


def test_stop_sentinel_unparks_an_idle_follower(weights):
    leader, follower, _ = _pair(weights, InProcKV())
    follower.start()
    leader.start()
    leader.generate([1, 2], max_new_tokens=3, temperature=0.0)
    leader.stop()   # publishes the sentinel
    t0 = time.time()
    follower.stop()  # must join promptly, not wait out a wave timeout
    assert time.time() - t0 < 10


def test_store_kv_needs_a_job_store():
    with pytest.raises(RuntimeError, match="initialize_from_config"):
        StoreKV()


# live traffic over a real job: the twin of tests/test_multihost_exec.py:139
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5], [11, 12, 13, 14], [3, 1]]
CANCEL_INDEX = 3
BUDGETS = [6, 6, 6, 96, 6]


def test_two_process_live_traffic_admission_mirrors_leader(weights):
    oracle_eng = JEngine(jax_init(JCFG, seed=0), JCFG, n_slots=4,
                         max_seq_len=128, prefill_buckets=(8,),
                         decode_block_size=4, logger=_QuietLogger())
    oracle_eng.start()
    try:
        oracle = [oracle_eng.generate(p, max_new_tokens=b, temperature=0.0)
                  for p, b in zip(PROMPTS, BUDGETS)]
    finally:
        oracle_eng.stop()
    leader, follower = torch_dist.run_procs(
        workers.live_admission, 2, weights, CFG, PROMPTS, BUDGETS,
        CANCEL_INDEX, timeout=240)
    served = leader["served"]
    for i, toks in enumerate(served):
        if i == CANCEL_INDEX:
            assert 2 <= len(toks) < BUDGETS[i], toks
            assert toks == oracle[i][:len(toks)]
        else:
            assert toks == oracle[i], (i, toks, oracle[i])
    # the follower's shadows, in the leader's id order, token for token
    assert follower["mirrored"] == served
    assert follower["kv_heads"] == leader["kv_heads"] == 1
