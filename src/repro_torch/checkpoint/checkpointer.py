"""Read side of the reference's checkpointer (port of the
``load_checkpoint`` part of ``repro.checkpoint.checkpointer``).

A reference checkpoint directory holds ``index.msgpack`` (tree paths,
shapes, dtypes, step) and ``arrays.npz`` (one array per ``/``-joined leaf
path, e.g. ``layers/attn/wq``). The payload is all the port needs, and it
reads it with numpy alone: no JAX, and no ``msgpack``, which the card's
machine may lack. Leaves the reference saved in bfloat16 come back as a
2-byte void (or ``ml_dtypes``) dtype;
:func:`repro_torch.core.convert.reference_tensor` turns them into
``torch.bfloat16`` bit for bit.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def load_checkpoint(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """{``/``-joined leaf path: numpy array} of a reference checkpoint."""
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as npz:
        return {key: npz[key] for key in npz.files}
