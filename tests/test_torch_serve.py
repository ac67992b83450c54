"""The port's serving engine (``repro_torch.serve``) against the JAX
package's (``repro.serve``): float32 reduced zamba2-2.7b, seed 0, the same
weights (``convert.params_from_reference``) and prompts, greedy decoding.
The tokens must be equal, request by request, and ``stats`` must report the
same keys.  Then the port's launcher runs on the CPU and prints its line."""
import dataclasses

import numpy as np
import jax
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.serve import DecodeParams as JDecodeParams
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import DecodeParams, Request, ServingEngine

ARCH = "zamba2-2.7b"
SLOTS, MAX_NEW, MAX_SEQ = 4, 6, 32


def _waves(engine, request_cls, prompts):
    """The launcher's loop: waves of ``SLOTS`` requests, lanes and cache
    reset per wave."""
    done = []
    for w in range(0, len(prompts), SLOTS):
        for rid in range(w, min(w + SLOTS, len(prompts))):
            engine.submit(request_cls(rid=rid, prompt=prompts[rid], max_new_tokens=MAX_NEW))
        engine.lanes = [None] * SLOTS
        engine.cache = None
        done += engine.run()
    return done


def test_greedy_serving_matches_reference():
    jcfg = dataclasses.replace(jreduced_config(jget_config(ARCH)), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(0)
    # the first wave mixes prompt lengths (left-padded with token 0, no mask)
    lens = [5, 9, 9, 7, 8, 8, 8, 8]
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]

    jeng = JServingEngine(jm, jp, max_seq=MAX_SEQ, slots=SLOTS,
                          decode=JDecodeParams(temperature=0.0, max_new_tokens=MAX_NEW))
    eng = ServingEngine(m, params, max_seq=MAX_SEQ, slots=SLOTS,
                        decode=DecodeParams(temperature=0.0, max_new_tokens=MAX_NEW))
    jdone = _waves(jeng, JRequest, prompts)
    want = {r.rid: r.out_tokens for r in jdone}
    done = _waves(eng, Request, prompts)
    got = {r.rid: r.out_tokens for r in done}
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values()) and len(got) == len(prompts)
    st = eng.stats(done)
    assert set(st) == set(jeng.stats(jdone))
    assert st["requests"] == len(prompts) and st["tokens"] == len(prompts) * MAX_NEW


def test_lane_refill_raises_as_in_reference():
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="float32")
    m = build_model(cfg, device="cpu")
    eng = ServingEngine(m, m.init(0), max_seq=MAX_SEQ, slots=2,
                        decode=DecodeParams(max_new_tokens=2))
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(4, dtype=np.int32) + rid,
                           max_new_tokens=2))
    eng._prefill_into_lanes()
    eng.lanes[0] = None  # a lane frees while requests wait
    with pytest.raises(NotImplementedError, match="cache surgery"):
        eng._prefill_into_lanes()


def test_temperature_sampling_is_seeded():
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="float32")
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    prompts = [np.arange(6, dtype=np.int32) + i for i in range(SLOTS)]

    def run(seed):
        eng = ServingEngine(m, params, max_seq=MAX_SEQ, slots=SLOTS, seed=seed,
                            decode=DecodeParams(temperature=1.0, max_new_tokens=MAX_NEW))
        return [r.out_tokens for r in _waves(eng, Request, prompts)]

    a, b = run(1), run(1)
    assert a == b
    assert all(0 <= t < cfg.vocab for toks in a for t in toks)


def test_launcher_serves_on_the_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "4", "--slots", "2",
                              "--max-new", "3", "--prompt-len", "6", "--max-seq", "16"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("served 4 requests, 12 tokens | TTFT ")
    assert out.rstrip().endswith("tok/s")
