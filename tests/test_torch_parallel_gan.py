"""The GAN vocoders' trainer step on 2 gloo ranks against 1 rank (see
``test_torch_parallel.py``), in a file of its own so that it runs beside
the others: HiFi-GAN, and Fre-GAN with its STFT loss over the global
batch, in float64 (in float32 a few discriminator gradients are rounding
noise whose sign the batch split decides, and Adam moves each by its full
learning rate; the GAN trainer's own tests hold two steps in float64 for
the same reason)."""
from test_torch_parallel import two_ranks_match_one_rank


def test_two_ranks_match_one_rank_gan():
    two_ranks_match_one_rank(("hifigan", "fregan"))
