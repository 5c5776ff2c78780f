"""Temporary folders of the port's tests that go when their test ends.

The port's tests write full-size checkpoints (a HuBERT-soft of 361 MB, a
GAN state of 811 MB) and pytest keeps the folders of its last three runs, so
a folder kept after its test only fills the disk. A test module takes
`tmp_path` from here (`from torch_tmp import tmp_path`) in place of pytest's
own; its module-scoped fixtures yield their folder and remove it with
`shutil.rmtree` after the yield.
"""
import shutil

import pytest


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's `tmp_path`, removed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
