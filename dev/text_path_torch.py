#!/usr/bin/env python3
"""chip_smoke.py's phase 19 alone, on one GPU: text from words to answers
(the TextSet pipeline, TextClassifier with its cnn, lstm and gru encoders
in fp32 and bf16, the twin's import served as id records, KNRM, a frozen
GloVe table, load_hf_bert into BERT-Base, the bf16 forecasters and
NeuralCF through Estimator.from_keras).

    python3 dev/text_path_torch.py

Builds the CUDA kernels first ((f) launches the flash kernels, (h) the
lookup and its scatter-add), turns TF32 off, runs phase 19 with all its
checks, prints its lines and the card's name and power limit, and writes
chiprun_out/text_path_torch.json.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    if not torch.cuda.is_available():
        print("text_path_torch: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"build: {_build.build():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rep = cs.phase_text(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    cs.log(f"phase 19: {rep['seconds']:.1f} s; launches {rep['launches']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "text_path_torch.json"),
              "w") as fh:
        json.dump(dict(card=card, **rep), fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
