"""The port keeps its own copies of the framework-free modules (it imports
nothing of the JAX package). Each copy against its original on the same
inputs."""

import dataclasses
import json

import numpy as np
import pytest

from optflow_tpu.core import config as jcfg
from optflow_tpu.engine import device_group as jdg
from optflow_tpu.engine import journal as jjournal
from optflow_tpu.engine import rois as jrois
from optflow_tpu.engine import sampler as jsampler
from optflow_tpu.sinks import http as jhttp
from optflow_tpu.sinks import store as jstore
from optflow_tpu_torch import convert
from optflow_tpu_torch.core import config as tcfg
from optflow_tpu_torch.engine import device_group as tdg
from optflow_tpu_torch.engine import journal as tjournal
from optflow_tpu_torch.engine import rois as trois
from optflow_tpu_torch.engine import sampler as tsampler
from optflow_tpu_torch.sinks import http as thttp
from optflow_tpu_torch.sinks import store as tstore

EXAMPLE = "docs/example.json"


def _plain(obj):
    """Dataclasses of the two packages compare by their fields."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if isinstance(obj, (tuple, list)):
        return [_plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def test_load_job_parses_the_documented_example_alike(tmp_path):
    want = jcfg.load_job(EXAMPLE)
    assert tcfg.load_job(EXAMPLE) == want
    gz = str(tmp_path / "job.json.gz")
    tcfg.dump_job(want, gz)
    assert tcfg.load_job(gz) == jcfg.load_job(gz) == want


def test_job_config_views_equal():
    args = jcfg.load_job(EXAMPLE)
    a, b = jcfg.JobConfig(dict(args)), tcfg.JobConfig(dict(args))
    assert a.style == b.style and a.debug == b.debug
    assert a.batch_size() == b.batch_size()
    for im in list(a.images)[:3] + [{}, {"scale": 1.0, "output_name": "x"}]:
        assert a.scale(im) == b.scale(im)
        assert a.output_type(im) == b.output_type(im)
        assert a.npoints(im) == b.npoints(im)
        assert a.output_path(im) == b.output_path(im)
        assert a.features_enabled(im) == b.features_enabled(im)
        assert a.detector_type(im) == b.detector_type(im)
        assert _plain(a.tv_params(im)) == _plain(b.tv_params(im))


@pytest.mark.parametrize(
    "im_args,args",
    [({}, {}), ({"tau": 0.1, "lambda": 0.2}, {"tau": 0.3, "nscales": 4}),
     ({"useInitialFlow": 1}, {"scaleStep": 0.5, "gamma": 0.25}),
     ({}, {"epsilon": 0, "iterations": 7, "warps": 2, "theta": 0.5})],
)
def test_tvl1_params_from_config_equal(im_args, args):
    want = jcfg.TVL1Params.from_config(im_args, args)
    got = tcfg.TVL1Params.from_config(im_args, args)
    assert _plain(got) == _plain(want)
    assert repr(got) == repr(want)  # the journal key hashes the repr
    assert convert.params_from_reference(dataclasses.asdict(want)) == got


def test_params_from_reference_rejects_other_fields():
    fields = dataclasses.asdict(jcfg.TVL1Params())
    with pytest.raises(ValueError):
        convert.params_from_reference({**fields, "extra": 1})
    fields.pop("tau")
    with pytest.raises(ValueError):
        convert.params_from_reference(fields)


@pytest.mark.parametrize(
    "im_args,args",
    [({}, {}), ({}, {"features": 2}), ({"features": 0}, {"features": 1}),
     ({"features": True}, {}), ({"features": "false"}, {"features": 1})],
)
def test_resolve_features_equal(im_args, args):
    assert tcfg.resolve_features(im_args, args) == jcfg.resolve_features(
        im_args, args
    )
    assert tcfg.feature_type(im_args, args) == jcfg.feature_type(im_args, args)
    assert tcfg.cfg_get(im_args, args, "features", None) == jcfg.cfg_get(
        im_args, args, "features", None
    )


@pytest.mark.parametrize(
    "roi_args",
    [{"top": 256, "bottom": 256}, {"top": 0}, {"custom": [3, 4, 50, 60]},
     {"custom": {"0": [1, 2, 30, 40], "1": [5, 6, 30, 40]}},
     {"custom": {"0": [1, 2, 30, 40]}}],
)
def test_get_rois_equal(roi_args):
    assert _plain(trois.get_rois(roi_args, 512, 1024)) == _plain(
        jrois.get_rois(roi_args, 512, 1024)
    )


@pytest.mark.parametrize(
    "im_args,args",
    [({}, {}), ({}, {"rois": {"top": 100}}),
     ({"rois": {"bottom": 50}}, {"rois": {"top": 100}})],
)
def test_resolve_rois_equal(im_args, args):
    got = trois.resolve_rois(im_args, args, 300, 400)
    want = jrois.resolve_rois(im_args, args, 300, 400)
    assert _plain(got) == _plain(want)
    for k, r in got.items():
        assert r.slices() == want[k].slices() and r.shape == want[k].shape


def test_pair_key_and_journal_round_trip(tmp_path):
    im = {"p": "a.png", "q": "b.png", "output_name": "n0"}
    for args in (None, {}, {"scale": 1.0, "iterations": 10}):
        assert tjournal.pair_key(im, args) == jjournal.pair_key(im, args)
        assert tjournal.pair_key_aliases(im, args) == jjournal.pair_key_aliases(
            im, args
        )
    # a journal written by one package is read alike by the other
    path = str(tmp_path / "j.jsonl")
    j = tjournal.JobJournal(path)
    j.record_pair("k1")
    j.record_flush()
    j.record_pair("k2")
    j.close()
    for mod in (tjournal, jjournal):
        r = mod.JobJournal(path)
        assert r.completed_keys("random_points") == {"k1"}
        assert r.completed_keys("map") == {"k1", "k2"}
        r.close()


def test_jsonl_sink_and_make_sink_equal(tmp_path):
    batch = [{"pId": "a", "qId": "b", "matches": {"p": [[1], [2]],
                                                  "q": [[3], [4]], "w": [1]}}]
    pa, pb = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert tstore.JsonlMatchSink(pa).put(batch)
    assert jstore.JsonlMatchSink(pb).put(batch)
    assert open(pa).read() == open(pb).read()
    assert tstore.JsonlMatchSink(pa).read_all() == batch
    null = tstore.NullMatchSink()
    null.put(batch)
    assert null.count == 1
    for args in ({"match_sink": "null"}, {"match_sink": "jsonl",
                                          "match_output": pa}, {"owner": "x"}):
        got, want = thttp.make_sink(args), jhttp.make_sink(args)
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "url", None) == getattr(want, "url", None)


def test_host_sampler_equal():
    rng = np.random.default_rng(0)
    fx = rng.standard_normal((6, 8)).astype(np.float32)
    fy = rng.standard_normal((6, 8)).astype(np.float32)
    mask = rng.random((6, 8)) > 0.3
    for features in (False, True):
        got = tsampler.random_points(
            fx, fy, mask, (trois.Roi(2, 3, 8, 6),) * 2, npoints=5,
            features=features, debug=True,
        )
        want = jsampler.random_points(
            fx, fy, mask, (jrois.Roi(2, 3, 8, 6),) * 2, npoints=5,
            features=features, debug=True,
        )
        assert got == want
    empty = tsampler.random_points(fx, fy, np.zeros_like(mask),
                                   (trois.Roi(0, 0, 8, 6),) * 2)
    assert empty["w"] == [0]
    im, args = {"pId": "a", "point_matches": got}, {}
    tsampler.move_pm(im, args)
    assert args["point_matches"][0]["matches"] == want and im["point_matches"] == {}


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25, 0.75, 2.0])
def test_frame_upload_dtype_equal(scale):
    assert tdg.frame_upload_dtype(scale) == jdg.frame_upload_dtype(scale)


def test_matches_from_samples_equal():
    samples = np.arange(20, dtype=np.float32).reshape(5, 4)
    for features in (False, True):
        got = tdg.matches_from_samples(
            samples, 3, trois.Roi(4, 6, 10, 10), 2.0, features
        )
        want = jdg.matches_from_samples(
            samples, 3, jrois.Roi(4, 6, 10, 10), 2.0, features
        )
        assert got == want and len(got["w"]) == 3


@pytest.mark.parametrize("name", ["OrbParams", "SurfParams", "MatchParams"])
def test_feature_parameter_classes_equal(name):
    """Own copies of the detector and matcher parameter classes: the same
    fields, defaults and config keys."""
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert _plain(jc()) == _plain(tc())
    assert [f.name for f in dataclasses.fields(jc)] == [
        f.name for f in dataclasses.fields(tc)]
    args = jcfg.load_job(EXAMPLE)
    overrides = {"nfeatures": 700, "scaleFactor": 1.3, "nlevels": 5,
                 "edgeThreshold": 20, "firstLevel": 1, "WTA_K": 3,
                 "patchSize": 25, "fastThreshold": 9,
                 "blurForDescriptor": 1, "hessianThreshold": 1600,
                 "nOctaves": 3, "nOctaveLayers": 3, "extended": "true",
                 "keypointsRatio": 0.02, "upright": 1, "ratio": 0.7,
                 "homo": 8, "ransac": 2.5}
    for im in ({}, overrides):
        want, got = jc.from_config(im, args), tc.from_config(im, args)
        assert _plain(want) == _plain(got)
        assert hash(got) == hash(tc.from_config(im, args))  # a group key
    assert _plain(tc.from_config(overrides, {})) != _plain(tc())
