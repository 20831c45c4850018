"""The audio tools (counterparts of `tools/audio_process/*.py`, with their
flags), on the port's `data/wav.py`.  Each is a module with `main(argv=None)`:

    python -m tpu_speech_commands_torch.audio_process.<tool> --help

All but one are numpy and scipy on the host: `add_noise`,
`annotation_update`, `audio_convert`, `audio_reverberation`, `audio_split`,
`silent_check`, `speech_command_split`, `speech_duration_check`,
`split_channel`, `wav_check`, `wav_filter`, `wav_merge`, `white_noise`, and
`audio_play`, `audio_record` and `wav_play`, which import pyaudio inside
`main`.  `vad_clip --model_path` scores 1-second frames through
`serving.make_batch_scorer`: the frontend kernel, then the classifier
kernel, on the card unless `--device cpu` is passed.  The MFCC comparator
of that directory is `tpu_speech_commands_torch.mfcc_feature`.  "The
reference" in the tools' docstrings is the upstream project the JAX
package re-implements, as in the JAX scripts.
"""
