"""The port's own `ListenerParams` and `pr` (`tpu_speech_commands_torch/
params.py`) against the JAX package's `tpu_speech_commands/params.py`: the
same fields, the same derived quantities (exact, they are integers), the same
JSON round trip, and two distinct global singletons."""
import json

import pytest

import tpu_speech_commands.params as jax_params
import tpu_speech_commands_torch.params as port_params

CONFIGS = {
    "default": {},
    "use_delta": {"use_delta": True},
    "window_t=0.05": {"window_t": 0.05},
    "hop_t=0.03": {"hop_t": 0.03},
    "alt_512": {"window_t": 0.025, "hop_t": 0.01, "n_fft": 512, "n_filt": 26,
                "n_mfcc": 13},
    "odd_rounding": {"buffer_t": 1.5, "window_t": 0.0251, "hop_t": 0.0101,
                     "sample_rate": 8000},
    "thresholds": {"threshold_config": [[6, 4], [3, 1]],
                   "threshold_center": 0.4},
}
DERIVED = ("window_samples", "hop_samples", "buffer_samples", "n_features",
           "max_samples", "feature_size", "n_fft_bins")


@pytest.fixture(autouse=True)
def _restore_port_pr():
    """tests/conftest.py restores only the JAX package's `pr`."""
    snap = port_params.pr.to_dict()
    yield
    port_params.pr.override(snap)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fields_and_derived_quantities_match_jax(name):
    kw = CONFIGS[name]
    port = port_params.ListenerParams().replace(**kw)
    jax_p = jax_params.ListenerParams().replace(**kw)
    assert port_params._STORED_FIELDS == jax_params._STORED_FIELDS
    assert port.to_dict() == jax_p.to_dict()
    for prop in DERIVED:
        assert getattr(port, prop) == getattr(jax_p, prop), prop
    assert port == port_params.ListenerParams(**port.__dict__)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_inject_and_save_round_trip(tmp_path, name):
    path = tmp_path / "params.json"
    path.write_text(json.dumps(port_params.ListenerParams().replace(
        **CONFIGS[name]).to_dict()))
    got = port_params.inject_params(str(path))
    assert got is port_params.pr
    out = tmp_path / "saved.json"
    port_params.save_params(str(out))
    assert json.loads(out.read_text()) == json.loads(path.read_text())
    jax_params.pr.override(json.loads(out.read_text()))
    assert jax_params.pr.to_dict() == port_params.pr.to_dict()


def test_the_two_globals_are_distinct():
    assert port_params.pr is not jax_params.pr
    assert port_params.ListenerParams is not jax_params.ListenerParams
    port_params.pr.override({"n_filt": 24})
    assert port_params.pr.n_filt == 24
    assert jax_params.pr.n_filt == 20


def test_override_is_atomic_and_skips_unknown_keys(capsys):
    p = port_params.ListenerParams()
    with pytest.raises(TypeError):
        p.override([("n_fft", 512)])
    p.override({"n_fft": 512, "not_a_field": 1})
    assert p.n_fft == 512
    assert "not_a_field" in capsys.readouterr().out


def test_inject_params_warns_on_a_bad_file(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    before = port_params.pr.to_dict()
    port_params.inject_params(str(bad))
    assert port_params.pr.to_dict() == before
    assert "Failed to load" in capsys.readouterr().out
    port_params.inject_params(str(tmp_path / "missing.json"))  # silent
    assert port_params.pr.to_dict() == before
