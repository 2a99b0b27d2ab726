"""The port's BinsFormer modules against the JAX package, on the CPU: the
deformable encoder layer, the decoder layer and the whole head, every
decoder layer's depth, bin edges and class logits in eval mode, and in
train mode with the BatchNorm statistics.

Seeded numpy variables for the JAX modules (`_random_variables`), carried
to the port by `state_dict_from_flax`; the same seeded inputs through both,
the JAX side under `jax.jit`. Widths as tests/test_model_zoo.py shrinks the
head: conv_dim 32 (8 heads of 4), 16 bins, the 5-level pyramid of a 64x96
frame (the conv stem's 32x48 to the last stage's 2x3), the head at 2
encoder and 4 decoder layers (the zoo's 6 and 9 run in
tests/test_torch_zoo_binsformer.py).

Tolerances as tests/test_torch_zoo.py's: rtol 1e-4 with atol 1e-5 of each
output's largest value for features, bin edges, logits and BatchNorm
statistics (train-mode values within JAX's own distance from a float64
run on top), 1e-3 m for depth.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from gedepth_tpu_torch.convert import state_dict_from_flax

from test_torch_gedepth import _random_variables
from test_torch_zoo import _assert_stats_match, _close, _double_copy
from test_torch_zoo_dpt import _strip

torch.set_num_threads(1)

CD, NBINS = 32, 16
# the zoo's 5-level pyramid of a 64x96 frame at Swin embed 16
CHANNELS = (64, 16, 32, 64, 128)
GRIDS = ((32, 48), (16, 24), (8, 12), (4, 6), (2, 3))
LEVELS = GRIDS[2:]                       # trans_index (2, 3, 4)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_encoder_layer_matches_jax():
    """One deformable encoder layer over the three levels (the exact rule,
    grid-centre reference points), batch 2."""
    from gedepth_tpu.models.binsformer import _EncoderLayer as JaxLayer
    from gedepth_tpu.models.hahi import _center_reference_points
    from gedepth_tpu_torch.models.binsformer import _EncoderLayer
    from gedepth_tpu_torch.ops.msda import center_reference_points

    n = sum(h * w for h, w in LEVELS)
    x, pe = _rand(1, 2, n, CD), _rand(2, 1, n, CD)
    jlayer = JaxLayer(CD)
    ref = jnp.asarray(_center_reference_points(LEVELS))
    variables = _random_variables(
        lambda k, a, b: jlayer.init(k, a, b, ref, LEVELS), jnp.asarray(x),
        jnp.asarray(pe), seed=3)
    want = jax.jit(lambda v, a, b: jlayer.apply(v, a, b, ref, LEVELS))(
        variables, jnp.asarray(x), jnp.asarray(pe))
    sd = state_dict_from_flax({"decode_head": {"encoder0":
                                               variables["params"]}})
    layer = _EncoderLayer(CD, 8, 3, 1024, 8)
    layer.load_state_dict(_strip(
        sd, "decode_head.transformer_encoder.encoder.layers.0."), strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(pe),
                    center_reference_points(LEVELS), LEVELS)
    _close(got.numpy(), want)


def test_decoder_layer_matches_jax():
    """One decoder layer: 17 queries (the class query and 16 bins) over a
    level of 96 tokens, batch 2; the positional encodings on query and key
    only."""
    from gedepth_tpu.models.binsformer import _DecoderLayer as JaxLayer
    from gedepth_tpu_torch.models.binsformer import _DecoderLayer

    q, qpe = _rand(4, 2, NBINS + 1, CD), _rand(5, 2, NBINS + 1, CD)
    mem, mpe = _rand(6, 2, 96, CD), _rand(7, 1, 96, CD)
    args = [jnp.asarray(a) for a in (q, qpe, mem, mpe)]
    jlayer = JaxLayer(CD)
    variables = _random_variables(jlayer.init, *args, seed=8)
    want = jax.jit(jlayer.apply)(variables, *args)
    sd = state_dict_from_flax({"decode_head": {"decoder0":
                                               variables["params"]}})
    layer = _DecoderLayer(CD, 8, 2048)
    layer.load_state_dict(_strip(
        sd, "decode_head.transformer_decoder.layers.0."), strict=True)
    with torch.no_grad():
        got = layer(*(torch.from_numpy(a) for a in (q, qpe, mem, mpe)))
    _close(got.numpy(), want)


def _pyramid(seed, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.2, 1.0, (batch, h, w, c)).astype(np.float32)
            for (h, w), c in zip(GRIDS, CHANNELS)]


def _head_outputs(got, want, tag):
    assert len(got) == len(want) == 4, tag
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["depth"].shape == (2, 1) + GRIDS[0]
        np.testing.assert_allclose(
            g["depth"].numpy().transpose(0, 2, 3, 1), np.asarray(w["depth"]),
            rtol=1e-4, atol=1e-3, err_msg=f"{tag} layer {i} depth")
        _close(g["bin_edges"].numpy(), w["bin_edges"],
               err_msg=f"{tag} layer {i} edges")
        _close(g["class_logits"].numpy(), w["class_logits"],
               err_msg=f"{tag} layer {i} class logits")


def test_binsformer_head_matches_jax():
    """The head at 2 encoder and 4 decoder layers on the pyramid: every
    layer's depth (at the stem's 32x48: the FPN is seeded by the finest
    encoder level), bin edges (monotone, min_depth to max_depth) and class
    logits, in eval mode and in train mode, and the train-mode BatchNorm
    statistics; in eval mode by default the last layer alone."""
    from gedepth_tpu.models.binsformer import BinsFormerHead as JaxHead
    from gedepth_tpu_torch.models.binsformer import BinsFormerHead

    feats = _pyramid(9)
    jin = [jnp.asarray(f) for f in feats]
    kw = dict(conv_dim=CD, n_bins=NBINS, num_encoder_layers=2,
              num_decoder_layers=4)
    jhead = JaxHead(in_channels=CHANNELS, **kw)
    variables = _random_variables(jhead.init, jin, seed=10)
    sd = state_dict_from_flax({"decode_head": variables["params"]},
                              {"decode_head": variables["batch_stats"]})
    head = BinsFormerHead(CHANNELS, **kw).eval()
    head.load_state_dict(_strip(sd, "decode_head."), strict=True)
    x = [_nchw(f) for f in feats]

    want = jax.jit(jhead.apply)(variables, jin)
    with torch.no_grad():
        got = head(x, all_layers=True)
        last = head(x)
    _head_outputs(got, want, "eval")
    assert len(last) == 1
    for k, v in last[0].items():
        assert torch.equal(v, got[-1][k]), k
    e = got[-1]["bin_edges"].numpy()
    assert (np.diff(e, axis=1) > 0).all()
    np.testing.assert_allclose(e[:, 0], 1e-3, rtol=1e-6)
    np.testing.assert_allclose(e[:, -1], 10.0, rtol=1e-5)

    want, mutated = jax.jit(lambda v, a: jhead.apply(
        v, a, True, mutable=["batch_stats"]))(variables, jin)
    f64 = _double_copy(head)
    head.train()
    with torch.no_grad():
        got = head(x)
        f64([t.double() for t in x])
    _head_outputs(got, want, "train")
    _assert_stats_match(head, mutated["batch_stats"], f64, "decode_head.")
