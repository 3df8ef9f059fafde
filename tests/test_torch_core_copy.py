"""The port's copies of the framework-free core against the reference.

``repro_torch.core.{links,topology,codecs,simulator,tuner,balancer,
pipeline}`` are copies of ``repro.core``'s modules with their imports
renamed.  Each case runs the same call through both and asserts ``==`` on
everything it returns — Table-2 predictions, Stage-1 trajectories,
balancer moves, pipeline chunk choices and codec pricing — for every
node profile, over the cases of tests/test_{simulator,tuner,balancer,
pipeline}.py.  Nothing here spawns a process.
"""

import dataclasses
import enum

import pytest

from repro.core import balancer as j_bal
from repro.core import codecs as j_codecs
from repro.core import links as j_links
from repro.core import pipeline as j_pipe
from repro.core import simulator as j_sim
from repro.core import tuner as j_tuner
from repro.core.topology import Collective as JColl
from repro_torch.core import balancer as t_bal
from repro_torch.core import codecs as t_codecs
from repro_torch.core import links as t_links
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import simulator as t_sim
from repro_torch.core import tuner as t_tuner
from repro_torch.core.topology import Collective as TColl

PROFILES = sorted(j_links.PROFILES)
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
MiB = j_sim.MiB


def plain(obj):
    """Framework-neutral form for ``==``: dataclasses and enums of either
    package become tuples and values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return tuple(sorted((plain(k), plain(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    return obj


def paths_of(pkg_links, profile):
    prof = pkg_links.PROFILES[profile]
    return ([prof.primary.name] + [l.name for l in prof.secondary],
            prof.primary.name)


def tune_both(profile, op, n, payload, noise=0.0, seed=0):
    out = []
    for links, sim, tuner, coll in ((j_links, j_sim, j_tuner, JColl),
                                    (t_links, t_sim, t_tuner, TColl)):
        model = sim.PathTimingModel(profile, noise=noise, seed=seed)
        paths, primary = paths_of(links, profile)
        res = tuner.initial_tune(paths, primary,
                                 lambda fr: model.measure(coll(op), n,
                                                          payload, fr))
        out.append((model, res))
    return out


@pytest.mark.parametrize("key", sorted(j_sim.FLEXLINK_IMPROVEMENT_PCT,
                                       key=lambda k: (k[0].value, k[1],
                                                      k[2])),
                         ids=lambda k: f"{k[0].value}-n{k[1]}-{k[2]}MiB")
def test_table2_prediction_equal(key):
    op, n, mib = key
    (jm, jr), (tm, tr) = tune_both("h800", op.value, n, mib * MiB)
    assert plain(tr) == plain(jr)
    for m, coll in ((jm, JColl), (tm, TColl)):
        assert m.nccl_baseline_GBps(coll(op.value), n, mib * MiB) == \
            jm.nccl_baseline_GBps(op, n, mib * MiB)
    assert tm.algbw_GBps(TColl(op.value), n, mib * MiB, tr.fractions()) == \
        jm.algbw_GBps(op, n, mib * MiB, jr.fractions())
    assert t_sim.FLEXLINK_IMPROVEMENT_PCT[(TColl(op.value), n, mib)] == \
        j_sim.FLEXLINK_IMPROVEMENT_PCT[key]


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_tables_equal(profile):
    assert plain(t_links.PROFILES[profile]) == plain(j_links.PROFILES[profile])
    assert t_links.idle_bw_opportunity(t_links.PROFILES[profile]) == \
        j_links.idle_bw_opportunity(j_links.PROFILES[profile])


@pytest.mark.parametrize("noise", [0.0, 0.05])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("profile", PROFILES)
def test_stage1_trajectory_equal(profile, op, noise):
    for n in (2, 4, 8):
        for mib in (1, 64, 256):
            (jm, jr), (tm, tr) = tune_both(profile, op, n, mib * MiB,
                                           noise=noise, seed=n + mib)
            assert plain(tr) == plain(jr), (n, mib)
            assert tm.total_time(TColl(op), n, mib * MiB, tr.fractions()) \
                == jm.total_time(JColl(op), n, mib * MiB, jr.fractions())


@pytest.mark.parametrize("op", ["all_gather", "all_reduce"])
@pytest.mark.parametrize("profile", PROFILES)
def test_balancer_moves_equal(profile, op):
    """A tuned LoadBalancer fed the same noisy timings, with a payload
    shift halfway (test_balancer.py's closed loop), moves the same units
    at the same calls."""
    pair = tune_both(profile, op, 8, 256 * MiB)
    runs = []
    for (model, res), bal, coll, sim in zip(pair, (j_bal, t_bal),
                                            (JColl, TColl), (j_sim, t_sim)):
        noisy = sim.PathTimingModel(profile, noise=0.1, seed=7)
        lb = bal.LoadBalancer(res.shares, paths_of(j_links, profile)[1])
        for call in range(400):
            payload = (256 if call < 200 else 1) * MiB
            lb.observe(noisy.measure(coll(op), 8, payload, lb.fractions()))
        runs.append((plain(lb.adjustments), plain(lb.shares),
                     lb.current_gap()))
    assert runs[1] == runs[0]


def test_evaluator_trend_equal():
    evs = [j_bal.Evaluator(window=5), t_bal.Evaluator(window=5)]
    for i in range(9):
        for ev in evs:
            ev.record({"a": 1.0 + (i % 3), "b": 2.0 - 0.1 * i})
    assert evs[1].trend(["a", "b"]) == evs[0].trend(["a", "b"])


STAGES = [(26.0, 26.0, 5.0), (26.0, 26.0, 50.0), (12.0, 48.0, 20.0),
          (50.0, 50.0, 2.0)]


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: "-".join(map(str, s)))
def test_optimal_chunk_bytes_equal(stage):
    js, ts = j_pipe.StageTimes(*stage), t_pipe.StageTimes(*stage)
    for total in (1 << 20, 3 << 20, 64 << 20, 256 << 20, 1 << 30):
        assert t_pipe.optimal_chunk_bytes(total, ts) == \
            j_pipe.optimal_chunk_bytes(total, js)
        for chunk in (1 << 20, 4 << 20, 16 << 20):
            for nb in (1, 2):
                assert t_pipe.pipeline_time_s(total, chunk, ts, nb) == \
                    j_pipe.pipeline_time_s(total, chunk, js, nb)
    assert t_pipe.N_BUFFERS == j_pipe.N_BUFFERS


@pytest.mark.parametrize("profile", PROFILES)
def test_codec_pricing_equal(profile):
    """choose_codecs on every registered codec, full payload and at tuned
    fractions, for every op / ring size / bucket."""
    assert plain(t_codecs._REGISTRY) == plain(j_codecs._REGISTRY)
    prof = j_links.PROFILES[profile]
    links = [prof.primary.name] + [l.name for l in prof.secondary]
    jm = j_sim.PathTimingModel(profile)
    tm = t_sim.PathTimingModel(profile)
    for name in sorted(j_codecs._REGISTRY):
        jc = {l: j_codecs.get_codec(name) for l in links[1:]}
        tc = {l: t_codecs.get_codec(name) for l in links[1:]}
        fracs = {l: 1.0 / len(links) for l in links}
        for op in OPS:
            for n in (2, 8):
                for mib in (1, 16, 256):
                    for fr in (None, fracs):
                        assert tm.choose_codecs(TColl(op), n, mib * MiB, tc,
                                                fracs=fr) == \
                            jm.choose_codecs(JColl(op), n, mib * MiB, jc,
                                             fracs=fr)
    for spec in ("", "secondary=fp8", "staged=bf16,ortho=fp8"):
        assert t_codecs.canonical_spec(spec) == j_codecs.canonical_spec(spec)
        assert t_codecs.parse_compress(spec) == j_codecs.parse_compress(spec)
