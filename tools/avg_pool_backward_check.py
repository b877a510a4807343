"""``F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)``'s
gradient against a depthwise conv of a 5x5 box of 1/25, on the CPU and the
card, float64 and float32, for a contiguous, a channels-last and an
NHWC-permuted input: the check behind ZERO-IG's explicit zero padding
(``enhax_torch/models/llie/zero_ig.py::_mean5_zero``; ROADMAP fault 3.10).

    python tools/avg_pool_backward_check.py      # on a machine with a card

One line a case: the forward's and the backward's max |d| from the conv.
"""

import torch


def main() -> None:
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    avg = lambda t: torch.nn.functional.avg_pool2d(t, 5, stride=1, padding=2,  # noqa: E731
                                                   count_include_pad=True)
    for dev in ("cpu", "cuda"):
        for dt in (torch.float64, torch.float32):
            x = torch.rand(2, 3, 64, 64, dtype=dt, device=dev)
            w = torch.rand(2, 3, 64, 64, dtype=dt, device=dev)
            k = torch.full((3, 1, 5, 5), 1 / 25, dtype=dt, device=dev)

            def box(t):
                return torch.nn.functional.conv2d(t, k, padding=2, groups=3)

            def grad(inp, pool):
                inp = inp.clone().requires_grad_(True)
                (pool(inp) * w).sum().backward()
                return inp.grad

            ref = grad(x, box)
            for name, inp in (("contiguous", x),
                              ("channels_last", x.contiguous(memory_format=torch.channels_last)),
                              ("NHWC permuted", x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2))):
                fwd = (avg(inp) - box(x)).abs().max().item()
                bwd = (grad(inp, avg) - ref).abs().max().item()
                print(f"{dev} {str(dt)[6:]}: {name}: forward |d| {fwd:.3e}, backward |d| {bwd:.3e}")


if __name__ == "__main__":
    main()
