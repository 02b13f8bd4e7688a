"""A head_dim-8 model (the JAX package's own test width) with weights drawn
from numpy, and the JAX package's logits and greedy tokens for it.

``attention_impl="auto"`` on the card runs the flash kernels here (they
take every head_dim from 1 to 256), and must give the JAX package's logits
and tokens all the same.  The JAX outputs are stored in
``torch_head_dim8_jax.npz`` beside this file, so that the card's test,
which runs where JAX is not installed, can hold the port against them;
``tests/test_torch_flash.py`` recomputes them with JAX and checks the file.
This module imports numpy only.
"""

from pathlib import Path

import numpy as np

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
           max_seq=32)
SEED = 11
BATCH, PROMPT, NEW_TOKENS = 2, 12, 8
JAX_OUTPUTS = Path(__file__).with_name("torch_head_dim8_jax.npz")


def numpy_params(seed: int = SEED) -> dict:
    """The JAX ``init_params`` tree's layout and scales, drawn with numpy;
    the norm weights are 1 plus noise, so that they matter."""
    rng = np.random.default_rng(seed)
    V, D, L, H, Hkv, hd, F = (CFG[k] for k in ("vocab_size", "d_model", "n_layers", "n_heads",
                                               "n_kv_heads", "head_dim", "d_ff"))

    def norm(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ones(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    block = {
        "attn_norm": ones(L, D), "wq": norm(L, D, H, hd, scale=D**-0.5),
        "wk": norm(L, D, Hkv, hd, scale=D**-0.5), "wv": norm(L, D, Hkv, hd, scale=D**-0.5),
        "wo": norm(L, H, hd, D, scale=(H * hd) ** -0.5), "mlp_norm": ones(L, D),
        "wi": norm(L, D, F, scale=D**-0.5), "wg": norm(L, D, F, scale=D**-0.5),
        "wd": norm(L, F, D, scale=F**-0.5),
    }
    return {"embed": norm(V, D, scale=1.0), "unembed": norm(D, V, scale=D**-0.5),
            "final_norm": ones(D), "block": block}


def prompt(seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(0, CFG["vocab_size"], (BATCH, PROMPT))
