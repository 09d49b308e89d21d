"""DND benchmark submission bundler (counterpart of
`dehaze_tpu/utils/bundle.py`; the reference's
`Uformer_ProbSparse/utils/bundle_submissions.py`, which no dehazing flow
calls): per-image `.mat` crops (`%04d_%02d.mat`, key "Idenoised_crop")
are bundled into one `.mat` per image (`%04d.mat`, object array
"Idenoised" with the israw / eval_version flags) under
`<folder>/<session>/`, 50 images × 20 crops for the DND protocol.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as sio


def bundle_submissions(submission_folder: str, session: str, *,
                       israw: bool, n_images: int = 50, n_blocks: int = 20,
                       eval_version: str = "1.0") -> str:
    """Bundle `<i>_<b>.mat` crop files into per-image DND submission files
    and return the output folder (`<submission_folder>/<session>`).
    n_images / n_blocks default to DND's 50 × 20; a missing crop file
    raises FileNotFoundError."""
    out_folder = os.path.join(submission_folder, session)
    os.makedirs(out_folder, exist_ok=True)
    for i in range(n_images):
        denoised = np.empty((n_blocks,), dtype=object)
        for bb in range(n_blocks):
            filename = "%04d_%02d.mat" % (i + 1, bb + 1)
            s = sio.loadmat(os.path.join(submission_folder, filename))
            denoised[bb] = s["Idenoised_crop"]
        sio.savemat(os.path.join(out_folder, "%04d.mat" % (i + 1)),
                    {"Idenoised": denoised, "israw": israw,
                     "eval_version": eval_version})
    return out_folder


def bundle_submissions_raw(submission_folder: str, session: str,
                           **kw) -> str:
    """≙ `bundle_submissions.py:13-42` (israw=True)."""
    return bundle_submissions(submission_folder, session, israw=True, **kw)


def bundle_submissions_srgb(submission_folder: str, session: str,
                            **kw) -> str:
    """≙ `bundle_submissions.py:44-73` (israw=False)."""
    return bundle_submissions(submission_folder, session, israw=False, **kw)
