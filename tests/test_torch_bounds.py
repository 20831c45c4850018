"""chip_smoke.py's kernel bounds, against counts made by hand from the shapes.

B = 8192 windows of 16,000 f32 samples at the default config: 245,760
frames of 1,024 samples, 513 bins, 20 filters (927 nonzero weights once
packed), 20 MFCCs; a 48-unit GRU or LSTM over (30, 20) features into 5
classes.  Peaks: 67 TFLOP/s f32, 989 TFLOP/s bf16, 3.35 TB/s.

- FFT frontend: a real-input 1024-point FFT is 2.5 n log2 n = 25,600
  FLOP a frame (6.29 GFLOP), with the cepstrum (4 a bin, 2 a packed
  weight, a 20 x 20 DCT: 4,706 a frame, 1.16 GFLOP) 0.111 ms of f32;
  its bytes, the kept frames' span of audio (29 hops of 512 and one frame
  of 1,024: 15,872 of the 16,000 samples, 520.1 MB) and 19.7 MB of
  features, take 0.1611 ms; route ct's kernel at n_fft = window = 768
  reads 15,616 samples a window (511.7 MB): 0.1586 ms;
- the dense DFT: 1,024 samples x 1,024 nonzero columns x 2 a frame, on
  the same span of audio;
- the load floor: the whole rows read (524.3 MB), and 32.8 KB or 19.7 MB
  written;
- the FFT kernel's radix-2 body and the CT split kernels compute the FFT
  frontend's function, so they share its bound.  The CT split's own operations are a floor of that algorithm,
  reported apart: stage 2, 14 products of 128 x 128 x 2 a frame (112.7
  GFLOP), stage 1, the n2 = 8 butterfly's 24 operations a lane, and the
  packed cepstrum: about 1.71 ms of f32;
- the stage cuts (ops/omission_kernel.py): the audio read (or, with a
  constant block, block 0's 16 rows) and a (B, 128) f32 output; the
  operations of the cut's function (`chip_smoke.cut_bounds`);
- the GRU and LSTM classifiers (the GRU's tile and SIMT kernels, one
  function): [x_t | h] @ [W; U] over 30 steps, 2 x gates x 48 x 68 a frame,
  and the head; f32 at 67 TFLOP/s on f32 features, bf16 at 989 TFLOP/s on
  bf16 features (4.82 and 6.42 GFLOP: 0.0049 and 0.0065 ms of bf16, above
  the 9.8 MB of bf16 features' 0.0029 ms).  The gate math's SFU floor is
  information beside it: 4 results a unit a step for the GRU at 16 a clock
  on 132 SMs at 1.98 GHz;
- the CNN classifier (both kernels, one function) at 30 x 20 into 5
  classes: each conv at the positions the VALID pool keeps (block 1 600,
  block 2 140 of 150, block 3 12, block 4 8 of 12), 2 a multiply-add.
  simple_cnn: 9 cin cout a position, 3,151,872 FLOP a window with the
  dense layer (256 x 128) and the head (128 x 5); simple_cnn_lite in the
  separable form, 9 cin + cin cout a position, 476,848.  f32 at 67
  TFLOP/s on f32 features, bf16 at 989 TFLOP/s on bf16 features.

The times are computed here in float64 and compared to 1e-9 relative.
"""
import importlib.util
import os

import pytest

from tpu_speech_commands_torch.models.cnn import SimpleCNN, SimpleCNNLite
from tpu_speech_commands_torch.ops.cnn_kernel import CNNClassifier
from tpu_speech_commands_torch.params import ListenerParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 8192 * 30
AUDIO_B = 4 * 8192 * 16000
# the kept frames' span a frontend reads: 29 hops of 512 and one frame
SPAN_B = 4 * 8192 * (29 * 512 + 1024)
SPAN_768_B = 4 * 8192 * (29 * 512 + 768)
FEATS_B = 4 * FRAMES * 20
CEPSTRUM = FRAMES * (4 * 513 + 2 * 927 + 2 * 20 * 20)
DFT = FRAMES * 2 * 1024 * 1024
CT_STAGE2 = FRAMES * 14 * 128 * 128 * 2
CT_STAGE1 = FRAMES * 128 * 24
# [x_t | h] @ [W; U] over 30 steps, 68 = D 20 + U 48 rows, 3 or 4 gates of
# 48 columns, 2 a multiply-add; the head 48 x 5
GRU = FRAMES * 2 * 3 * 48 * 68 + 8192 * 2 * 48 * 5
LSTM = FRAMES * 2 * 4 * 48 * 68 + 8192 * 2 * 48 * 5
CNN = 8192 * 3_151_872
CNN_LITE = 8192 * 476_848

EXPECTED = {  # name: (bound_by, ms)
    "mfcc_frontend": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    "mfcc_frontend_radix2": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    "dft_frontend_bf16": ("operations", DFT / 989e9 + CEPSTRUM / 67e9),
    "ct_frontend": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    "ct_frontend_paired": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    "ct_frontend_ppmel": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    "ct_frontend_dup": ("bytes", (SPAN_B + FEATS_B) / 3.35e9),
    # route ct's kernel at n_fft = window = 768: 30 frames of 20 features
    # over a span of 15,616 samples
    "mixed_fft_frontend": ("bytes", (SPAN_768_B + FEATS_B) / 3.35e9),
    "dense_dft_combined": ("operations", (DFT + CEPSTRUM) / 67e9),
    "dense_dft_halves": ("operations", (DFT + CEPSTRUM) / 67e9),
    "load_rowsum": ("bytes", (AUDIO_B + 4 * 8192) / 3.35e9),
    "load_broadcast": ("bytes", (AUDIO_B + 4 * 8192 * 600) / 3.35e9),
    "gru_classifier": ("operations", GRU / 67e9),
    "gru_classifier_simt": ("operations", GRU / 67e9),
    "gru_classifier bfloat16": ("operations", GRU / 989e9),
    "lstm_classifier": ("operations", LSTM / 67e9),
    "lstm_classifier_simt": ("operations", LSTM / 67e9),
    "lstm_classifier bfloat16": ("operations", LSTM / 989e9),
    "cnn_classifier": ("operations", CNN / 67e9),
    "cnn_classifier_simt": ("operations", CNN / 67e9),
    "cnn_classifier simple_cnn float32": ("operations", CNN / 67e9),
    "cnn_classifier simple_cnn bfloat16": ("operations", CNN / 989e9),
    "cnn_classifier simple_cnn_lite float32": ("operations", CNN_LITE / 67e9),
    "cnn_classifier simple_cnn_lite bfloat16": ("operations",
                                                CNN_LITE / 989e9),
}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bounds(chip_smoke):
    cnn = CNNClassifier(SimpleCNN(5, 30, 20)).consts
    out = chip_smoke.kernel_bounds(ListenerParams(), 8192, 16000,
                                   (30, 20, 48, 5), cnn)
    for model in (SimpleCNN(5, 30, 20), SimpleCNNLite(5, 30, 20)):
        lowered = CNNClassifier(model).consts.lowered
        name = "simple_cnn_lite" if model.separable else "simple_cnn"
        for dtype in ("float32", "bfloat16"):
            out[f"cnn_classifier {name} {dtype}"] = chip_smoke.cnn_bound(
                lowered, model.separable, 8192, dtype)
    for name, gates in (("gru_classifier", 3), ("lstm_classifier", 4)):
        out[f"{name} bfloat16"] = chip_smoke.rnn_bound(8192, (30, 20, 48, 5),
                                                       gates, "bfloat16")
    return out


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_kernel_bound_matches_the_hand_count(bounds, name):
    by, ms = EXPECTED[name]
    assert bounds[name][1] == by
    assert bounds[name][0] == pytest.approx(ms, rel=1e-9)


def test_ct_stage2_count(chip_smoke, bounds):
    """112.7 GFLOP of stage 2 at B = 8192, 1.68 ms of the CT split's ~1.71
    ms floor; the per-piece mel doubles the filterbank term.  The kernel's
    bound is the function's, 0.1611 ms of bytes."""
    assert CT_STAGE2 == pytest.approx(112.7e9, rel=1e-3)
    assert CT_STAGE2 / 67e9 == pytest.approx(1.682, abs=1e-3)
    p = ListenerParams()
    floor = chip_smoke.ct_split_flops(p, 8192)
    assert floor == pytest.approx(CT_STAGE2 + CT_STAGE1 + CEPSTRUM, rel=1e-12)
    assert floor / 67e9 == pytest.approx(1.711, abs=1e-3)
    assert chip_smoke.ct_split_flops(p, 8192, True) == pytest.approx(
        floor + FRAMES * 2 * 927, rel=1e-12)
    assert bounds["ct_frontend"] == bounds["mfcc_frontend"]
    assert bounds["ct_frontend"][0] == pytest.approx(0.1611, abs=1e-4)
    assert bounds["mixed_fft_frontend"][0] == pytest.approx(0.1586, abs=1e-4)


CUT_BYTES = {False: AUDIO_B + 4 * 8192 * 128,            # 528.5 MB
             True: 4 * 16 * 16000 + 4 * 8192 * 128}       # block 0 and out
FFT_POWER = FRAMES * (2.5 * 1024 * 10 + 4 * 513)
CUT_OPS = {
    "load": 2 * 8192 * 16000,
    "framing": FRAMES * 1024,
    "butterfly": FRAMES * 128 * 24,
    "power": FFT_POWER,
    "mel": FFT_POWER + FRAMES * 2 * 927,
    "log": FFT_POWER + FRAMES * (2 * 927 + 21),
    "full": FFT_POWER + FRAMES * (2 * 927 + 21 + 2 * 20 * 20),
}


@pytest.mark.parametrize("constant_block", [False, True],
                         ids=["streamed", "constant_block"])
@pytest.mark.parametrize("stage", sorted(CUT_OPS))
def test_cut_bound_matches_the_hand_count(chip_smoke, stage, constant_block):
    """A stage cut's bound: the larger of its operations at the f32 peak
    and its bytes; both kernels' cuts of a stage share it."""
    ops_ms = CUT_OPS[stage] / 67e9
    bytes_ms = CUT_BYTES[constant_block] / 3.35e9
    bounds = chip_smoke.cut_bounds(ListenerParams(), 8192, 16000,
                                   constant_block)
    names = [f"{k}_truncated_{stage}" for k in ("ct", "fft")
             if f"{k}_truncated_{stage}" in bounds]
    assert names[0].startswith("ct") and len(names) == (
        1 if stage == "butterfly" else 2)
    for name in names:
        assert bounds[name][1] == ("operations" if ops_ms >= bytes_ms
                                   else "bytes")
        assert bounds[name][0] == pytest.approx(max(ops_ms, bytes_ms),
                                                rel=1e-9)


def test_streamed_cuts_are_bound_by_bytes_and_constant_ones_by_operations(
        chip_smoke):
    """Streamed, every cut reads the 524.3 MB of audio: 0.1578 ms.  With a
    constant block the audio is 1 MB and every cut's operations bind."""
    p = ListenerParams()
    streamed = chip_smoke.cut_bounds(p, 8192, 16000, False)
    constant = chip_smoke.cut_bounds(p, 8192, 16000, True)
    assert len(streamed) == len(constant) == 13
    for name, (ms, by) in streamed.items():
        assert by == "bytes" and ms == pytest.approx(0.1578, abs=1e-4)
        assert constant[name][1] == "operations"
    assert constant["fft_truncated_full"][0] == pytest.approx(0.1112, abs=1e-3)


@pytest.mark.parametrize("n_fft,hop_t,frames,bins,packed,by", [
    (768, 0.032, 30, 385, 691, "bytes"),
    (1536, 0.016, 57, 769, 1400, "operations"),
    (2816, 0.016, 52, 1409, 2581, "operations"),
])
def test_mixed_fft_bound_at_each_timed_config(chip_smoke, n_fft, hop_t, frames,
                                              bins, packed, by):
    """Route ct's kernel where chip_smoke.py times it: a real FFT of n_fft
    points, 2.5 n log2 n a frame (the nominal count for a mixed radix), and
    the cepstrum over the packed filterbank (691, 1400, 2581 nonzero
    weights), against the kept frames' span of audio (15,872 samples at
    both hop-256 configs, 15,616 at 768) and the features.  At hop 256 the
    operations bind: 0.330 ms at 1536, 0.587 ms at 2816."""
    import math

    p = ListenerParams(n_fft=n_fft, window_t=n_fft / 16000, hop_t=hop_t)
    assert (p.n_features, p.n_fft_bins) == (frames, bins)
    f = 8192 * frames
    ops = f * (2.5 * n_fft * math.log2(n_fft) + 4 * bins + 2 * packed
               + 2 * 20 * 20)
    span = (frames - 1) * p.hop_samples + n_fft
    assert span == {768: 15616, 1536: 15872, 2816: 15872}[n_fft]
    nbytes = 4 * 8192 * span + 4 * f * 20
    want = max(ops / 67e9, nbytes / 3.35e9)
    got = chip_smoke.frontend_bound(p, 8192)
    assert got[1] == by and got[0] == pytest.approx(want, rel=1e-9)


def test_fft_frontend_operations_are_below_its_bytes(bounds):
    """The FFT frontend is bound by its bytes: its operations, the real FFT
    and the packed cepstrum, take 0.111 ms at the f32 peak."""
    ops_ms = (FRAMES * 2.5 * 1024 * 10 + CEPSTRUM) / 67e9
    assert ops_ms == pytest.approx(0.1112, abs=1e-4)
    assert bounds["mfcc_frontend"][0] > ops_ms


def test_rnn_bf16_bounds_are_operations_above_the_bf16_features(chip_smoke,
                                                                bounds):
    """bf16: 0.0049 ms (GRU) and 0.0065 ms (LSTM) of tensor-core work, above
    the 0.0029 ms the bf16 features and f32 logits take to read and write.
    The GRU's gate math needs 47.2 M special-function results, 0.0112 ms at
    the SFU rate: information, not part of the bound."""
    assert bounds["gru_classifier bfloat16"][0] == pytest.approx(0.00487,
                                                                 abs=1e-5)
    assert bounds["lstm_classifier bfloat16"][0] == pytest.approx(0.00649,
                                                                  abs=1e-5)
    feats_bf16 = (2 * FRAMES * 20 + 4 * 8192 * 5) / 3.35e9
    assert feats_bf16 == pytest.approx(0.00298, abs=1e-5)
    sfu = chip_smoke.sfu_floor_ms(8192, (30, 20, 48, 5), 4)
    assert sfu == pytest.approx(8192 * 30 * 48 * 4 / (16 * 132 * 1.98e9) * 1e3,
                                rel=1e-12)
    assert sfu == pytest.approx(0.0113, abs=1e-4)
    assert bounds["gru_classifier"] == bounds["gru_classifier_simt"]


def test_cnn_bounds_count_the_kept_positions_and_the_separable_form(bounds):
    """The old count took every conv position (3,833,856 FLOP a window,
    0.4688 ms); the pool keeps fewer: 0.3854 ms f32, 0.0261 ms bf16.  The
    lite model needs 6.6x less than the composed dense kernel does."""
    assert bounds["cnn_classifier"][0] == pytest.approx(0.3854, abs=1e-4)
    assert bounds["cnn_classifier simple_cnn bfloat16"][0] == pytest.approx(
        0.0261, abs=1e-4)
    assert bounds["cnn_classifier simple_cnn_lite float32"][0] == \
        pytest.approx(0.0583, abs=1e-4)
    assert 8192 * 3_833_856 / 67e9 == pytest.approx(0.4688, abs=1e-4)
    assert CNN / CNN_LITE == pytest.approx(6.61, abs=1e-2)
