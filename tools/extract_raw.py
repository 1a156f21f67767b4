#!/usr/bin/env python
"""Print the raw mixed-estimate frame of an output file
(counterpart of ``/root/reference/tools/extract_raw.py``)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pauxy_jax.analysis.extraction import extract_mixed_estimates  # noqa: E402

if __name__ == "__main__":
    data = extract_mixed_estimates(sys.argv[1])
    print(data.to_string(index=False))
