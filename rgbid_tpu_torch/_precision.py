"""Global float32 precision policy (counterpart of rgbid_tpu/_precision.py).

Every matrix product on the tracking path is small and accuracy-critical
(6x6 normal equations reduced over ~1e5 pixels, 4x4 SE(3) composes, 3x3
orthonormalizations); bf16 accumulation there was measured at 13.4 mm ATE
against 1.4 mm on the same clip. On an NVIDIA card PyTorch keeps float32
matmuls exact by default but runs float32 convolutions through cuDNN in
TF32, which would carry the pyramid blurs (ops/image.py) at about three
decimal digits. Both are pinned to full float32 here.

Imported for its side effect by rgbid_tpu_torch/__init__.py.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
