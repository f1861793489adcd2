"""Train, validate or score generation with the PyTorch port.

The peer of ``tools/run_net.py`` (same flags, plus ``--cpu``):

    python tools/run_net_torch.py --config-file configs/bench_train_tpu.py --task train
    python tools/run_net_torch.py --config-file configs/bench_train_tpu.py \
        --task val_gen --gen_num 64

It runs on the CUDA card and raises where there is none, unless ``--cpu``
is given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from difffacto_torch.runner.cli import main  # noqa: E402

if __name__ == "__main__":
    main()
