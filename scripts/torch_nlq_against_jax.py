"""Train VSLNet through both NLQ entries on the CPU and print both
evaluations: ``avion_tpu_torch.egonlq.train_nlq.main`` (``--device cpu``)
and ``avion_tpu.egonlq.train_nlq.main`` on the planted-span features of
``tests/test_nlq_entry.py`` (``chip_smoke.write_nlq_features``: 48
samples of 32 rows, 96-wide video, 64-wide query) at that test's settings
(dim 64, 4 heads, drop 0, lr 2e-3, 12 epochs of 3 steps), evaluated on the
training samples.  The two runs draw their initial weights from different
generators, so their metrics agree in size, not in digits.

    JAX_PLATFORMS=cpu python scripts/torch_nlq_against_jax.py

Prints one JSON line, ``{"port": {...}, "jax": {...}}``; about a minute,
most of it the JAX entry's compilation.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> dict:
    import chip_smoke
    from avion_tpu.egonlq import train_nlq as jax_entry
    from avion_tpu.egonlq.vslnet import VSLNet as JaxVSLNet
    from avion_tpu_torch.egonlq import train_nlq

    with tempfile.TemporaryDirectory() as root:
        ann = chip_smoke.write_nlq_features(root, 48, seed=0, vdim=96,
                                            qdim=64)
        args = [f"annotations={ann}", f"feature_dir={root}", "dim=64",
                "num_heads=4", "max_pos_len=32", "drop_rate=0.0", "lr=2e-3",
                "epochs=12", "batch_size=16", "print_freq=100"]
        port = train_nlq.main(args + [f"output_dir={root}/port",
                                      f"val_annotations={ann}",
                                      "--device", "cpu"])["val"]
        params = jax_entry.main(args + [f"output_dir={root}/jax"])
        cfg = jax_entry.NLQConfig(
            annotations=ann, val_annotations=ann, feature_dir=root, dim=64,
            num_heads=4, max_pos_len=32, drop_rate=0.0, batch_size=16)
        ref = jax_entry.evaluate(cfg, JaxVSLNet(
            dim=64, num_heads=4, max_pos_len=32, drop_rate=0.0), params)
    out = {"port": port, "jax": ref}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
