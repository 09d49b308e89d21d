#!/usr/bin/env python3
"""Write tests/data/uformer_e4_bf16.msgpack and its digests with the JAX
package, for reading by the PyTorch port where neither flax nor msgpack is
installed (`chip_smoke.py`'s zoo phase, `tests/test_torch_port_msgpack.py`).

    python3 scripts/make_msgpack_fixture.py

The checkpoint is `dehaze_tpu.train.checkpoint.save_checkpoint` of a
ProbSparse Uformer at embed_dim 4 (the ModelConfig defaults otherwise: the
evaluation CLIs take no depth flag), its weights a seeded torch init
carried across by the JAX package's converter and stored as bfloat16,
which keeps the file under 1 MB (0.75 MB; float32 would take 1.5). The
JSON beside it names the model flags and holds the SHA-256 of each tensor
of the float32 state_dict those params give through the port's bridge
(`utils.convert.state_dict_from_jax_params`), so a reader is held to the
bits. Needs jax, flax and torch.
"""

import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NAME = "uformer_e4_bf16"
EMBED_DIM = 4
SEED = 16


def digests(state_dict) -> dict:
    """{name: SHA-256 of the float32 tensor's C-order bytes}."""
    return {k: hashlib.sha256(v.float().contiguous().numpy().tobytes())
            .hexdigest() for k, v in sorted(state_dict.items())}


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dehaze_tpu.train.checkpoint import save_checkpoint
    from dehaze_tpu.utils.convert_torch import convert_uformer_state_dict
    from dehaze_tpu_torch.config import ModelConfig
    from dehaze_tpu_torch.models.uformer import Uformer
    from dehaze_tpu_torch.utils.convert import state_dict_from_jax_params

    torch.manual_seed(SEED)
    sd = Uformer(ModelConfig(embed_dim=EMBED_DIM)).state_dict()
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          convert_uformer_state_dict(sd))
    out = os.path.join(REPO, "tests", "data", NAME)
    save_checkpoint(out + ".msgpack", 0, params,
                    extra={"embed_dim": EMBED_DIM, "seed": SEED})
    widened = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    meta = {"file": f"{NAME}.msgpack",
            "flags": ["--embed_dim", str(EMBED_DIM)],
            "params_dtype": "bfloat16",
            "sha256": digests(state_dict_from_jax_params(widened))}
    with open(out + ".json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{out}.msgpack: {os.path.getsize(out + '.msgpack')} bytes, "
          f"{len(meta['sha256'])} tensors")


if __name__ == "__main__":
    main()
