"""Bridge from the pair engine to the feature pre-alignment module.

The engine's ``aligner`` contract mirrors find_alignment
(src/features.cpp:46): aligner(frame1, frame0, im_args, args) -> 2x3
affine mapping frame1 coordinates into frame0 space, the identity when
alignment fails its sanity gates.

The feature module is part of this package and always present, so nothing
here falls back to the identity on an import error: a broken installation
fails loudly instead of silently skipping the alignment.
"""

from __future__ import annotations

import numpy as np

from optflow_tpu_torch.features.align import find_alignment


def default_aligner(frame1, frame0, im_args, args, device="cuda") -> np.ndarray:
    """The package's own aligner. The engine calls an aligner with four
    arguments, so a caller binds another device with
    ``functools.partial(default_aligner, device=...)``, as the CLI does; the
    batched runner replaces either by the batched device aligner for whole
    groups."""
    return find_alignment(frame1, frame0, im_args, args, device=device)


def is_default_aligner(aligner) -> bool:
    """True for ``default_aligner`` and for a ``functools.partial`` of it."""
    return getattr(aligner, "func", aligner) is default_aligner
