"""Zero-DiDCE: dual-input fast curve estimation (a Zero-DCE derivative).

Port of ``enhax/models/llie/zero_didce.py``: a 4-conv curve net run on the
image x and on its inverse 1 - x, the two curves averaged, then a
brightness-adaptive number of quadratic curve steps with a gain a step:

  m = mean(x); n1 = 0.63; n3 = -0.79 m^2 + 0.81 m + 1.4
  b = floor(piecewise polynomial of m)
  b times: y += r (y^2 - y) (n1 - mean(y)) / (n3 - mean(y))

Both means run over the whole batch, as the JAX package takes them: a batch
of two images is one request, not two. The loop is ``max_iters`` (12)
steps, each masked by ``i < b`` as tensor ops (no host sync, the same
iterates as a loop of b steps). Images are NHWC; the convs run NCHW.
Parameter names are the JAX package's (``e_conv1``, ``e_conv2``,
``e_conv3``, ``e_conv7``), which are the reference's. The loss is
``zero_reference_loss``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.models.llie.zero_dce import zero_reference_loss
from enhax_torch.nn.layers import flax_conv2d


class ZeroDiDCEModule(nn.Module):
    def __init__(self, num_channels: int = 32, max_iters: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        nc, g = num_channels, generator
        self.max_iters = max_iters
        self.e_conv1 = flax_conv2d(3, nc, 3, generator=g)
        self.e_conv2 = flax_conv2d(nc, nc, 3, generator=g)
        self.e_conv3 = flax_conv2d(nc, nc, 3, generator=g)
        self.e_conv7 = flax_conv2d(2 * nc, 3, 3, generator=g)

    def curves(self, t: torch.Tensor) -> torch.Tensor:
        x1 = torch.relu(self.e_conv1(t))
        x2 = torch.relu(self.e_conv2(x1))
        x3 = torch.relu(self.e_conv3(x2))
        return torch.tanh(self.e_conv7(torch.cat([x1, x3], 1)))

    def forward(self, x: torch.Tensor) -> dict:
        xc = x.permute(0, 3, 1, 2)
        r = ((self.curves(xc) + self.curves(1.0 - xc)) / 2.0).permute(0, 2, 3, 1)
        m = x.mean()
        n1 = 0.63
        s = m * m
        n3 = -0.79 * s + 0.81 * m + 1.4
        b = torch.where(m < 0.1, -25.0 * m + 10.0,
                        torch.where(m < 0.45, 17.14 * s - 15.14 * m + 10.0,
                                    5.66 * s - 2.93 * m + 7.2))
        n_iters = torch.floor(b).clamp(max=self.max_iters)
        y = x
        for i in range(self.max_iters):
            ym = y.mean()
            step = r * (y * y - y) * ((n1 - ym) / (n3 - ym))
            y = torch.where(i < n_iters, y + step, y)
        return {"enhanced": y, "adjust": r}


@MODELS.register(name="zero_didce", arch="zero_dce", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def zero_didce(num_channels: int = 32, generator: torch.Generator | None = None,
               **kwargs) -> Model:
    return Model(
        name="zero_didce", arch="zero_dce",
        module=ZeroDiDCEModule(num_channels=num_channels, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        loss_fn=zero_reference_loss(),
        required_inputs=("image",),
        size_divisor=1,
    )
