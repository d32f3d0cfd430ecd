"""Small versions of the cells, for rehearsals and tests on the CPU: every
width cut, WaveRNN's folds 500 samples wide, the traffic cut to a few
texts of 200 frames a call."""
from __future__ import annotations

import copy

from benchmark.harness import registry

SYNTHESIZER = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, lstm_dims=32,
                   postnet_dims=16, gst_E=16, gst_token_num=4, gst_num_heads=2,
                   gst_ref_filters=[4, 4, 8, 8, 8, 8])
HIFIGAN = dict(upsample_initial_channel=16)
WAVERNN = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=1, bits=5,
               gen_target_tpu=400, gen_overlap_tpu=50)


def override(name: str, texts: int = 3, steps: int = 200) -> dict:
    cell = registry.cell(name)
    cfg = copy.deepcopy(cell["config"])
    cfg["synthesizer"].update(SYNTHESIZER)
    cfg["vocoder"].update(HIFIGAN if cfg["vocoder"]["arch"] == "hifigan" else WAVERNN)
    mix = copy.deepcopy(cell["traffic"])
    mix["texts_per_call"], mix["voices"] = texts, 2
    mix["tts_batch"]["steps"] = steps
    if "batch_size" in mix["tts_batch"]:
        mix["tts_batch"]["batch_size"] = texts
    return {"config": cfg, "traffic": mix}
