"""DeepSpeech 0.1.0 checkpoint → the JAX-layout flat npz that the port's
`extract_audio --weights` reads (counterpart of the repository's
tools/convert_deepspeech.py, without JAX).

    python -m hfa_gp_tpu_torch.tools.convert_deepspeech ds_vars.npz ds.npz

The reference extracts `aud.npy` with AD-NeRF's DeepSpeech tooling, which
runs Mozilla's `deepspeech-0.1.0-models` TF graph. The source here is a
plain npz of that checkpoint's variables (TF name, `/` or `|` separated →
array), dumped on any machine with TensorFlow:

    import tensorflow as tf, numpy as np
    r = tf.train.load_checkpoint("models/ckpt")
    np.savez("ds_vars.npz", **{k.replace("/", "|"): r.get_tensor(k)
        for k in r.get_variable_to_shape_map()})

The arrays carry over as they are: the dense kernels h1, h2, h3, h5 and h6
(→ logits) are (cin, cout), and each BasicLSTMCell is one
(cin + units, 4·units) kernel with gates (i, j, f, o) and the forget bias
added at run time; `preprocess/convert.deepspeech_from_jax` turns them
into the port's layers. Every shape is checked against the port's
DeepSpeech.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..preprocess.deepspeech import N_CHARS, N_HIDDEN, N_INPUT
from ..utils.convert import save_npz

NAME_MAP = {
    "h1": ("h1", "weight"), "b1": ("h1", "bias"),
    "h2": ("h2", "weight"), "b2": ("h2", "bias"),
    "h3": ("h3", "weight"), "b3": ("h3", "bias"),
    "h5": ("h5", "weight"), "b5": ("h5", "bias"),
    "h6": ("logits", "weight"), "b6": ("logits", "bias"),
    "bidirectional_rnn|fw|basic_lstm_cell|weights": ("lstm_fw", "kernel"),
    "bidirectional_rnn|fw|basic_lstm_cell|biases": ("lstm_fw", "bias"),
    "bidirectional_rnn|bw|basic_lstm_cell|weights": ("lstm_bw", "kernel"),
    "bidirectional_rnn|bw|basic_lstm_cell|biases": ("lstm_bw", "bias"),
    # the newer spellings of the same variables
    "bidirectional_rnn|fw|basic_lstm_cell|kernel": ("lstm_fw", "kernel"),
    "bidirectional_rnn|fw|basic_lstm_cell|bias": ("lstm_fw", "bias"),
    "bidirectional_rnn|bw|basic_lstm_cell|kernel": ("lstm_bw", "kernel"),
    "bidirectional_rnn|bw|basic_lstm_cell|bias": ("lstm_bw", "bias"),
}


def param_shapes() -> dict[str, dict[str, tuple[int, ...]]]:
    """The JAX-layout shape of every DeepSpeech parameter."""
    def dense(cin, cout):
        return {"weight": (cin, cout), "bias": (cout,)}

    lstm = {"kernel": (2 * N_HIDDEN, 4 * N_HIDDEN), "bias": (4 * N_HIDDEN,)}
    return {"h1": dense(N_INPUT, N_HIDDEN), "h2": dense(N_HIDDEN, N_HIDDEN),
            "h3": dense(N_HIDDEN, N_HIDDEN), "lstm_fw": lstm,
            "lstm_bw": lstm, "h5": dense(2 * N_HIDDEN, N_HIDDEN),
            "logits": dense(N_HIDDEN, N_CHARS)}


def convert(tf_vars: dict) -> dict:
    """{TF variable name: array} → the DeepSpeech params tree; raises on a
    missing layer or a shape that is not the port's."""
    out: dict = {}
    for tf_name, arr in tf_vars.items():
        key = tf_name.replace("/", "|")
        if key in NAME_MAP:
            layer, part = NAME_MAP[key]
            out.setdefault(layer, {})[part] = np.asarray(arr, np.float32)
    want = param_shapes()
    missing = sorted(f"{layer}/{part}" for layer, parts in want.items()
                     for part in parts if part not in out.get(layer, {}))
    if missing:
        raise ValueError(f"the checkpoint dump is missing {missing}")
    wrong = {f"{layer}/{part}": (out[layer][part].shape, shape)
             for layer, parts in want.items() for part, shape in parts.items()
             if out[layer][part].shape != shape}
    if wrong:
        raise ValueError(f"shapes (got, want) that are not DeepSpeech "
                         f"0.1.0's: {wrong}")
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="npz of the TF checkpoint's variables")
    p.add_argument("out", help="output npz")
    args = p.parse_args(argv)
    with np.load(args.src) as f:
        params = convert(dict(f))
    save_npz(params, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
