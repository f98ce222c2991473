"""The work of one train step, counted on the reference at the step's
shapes, so that the count does not change whatever the program does.

``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls and
convolutions of the reference's step (forward, both backward passes) run on
the ``meta`` device: shapes only, no arithmetic. A convolution's data
gradient and weight gradient each cost its forward's multiply-adds;
PyTorch's own rule counts a grouped convolution's weight gradient as if the
convolution were dense (``groups`` times too many), so ``conv_backward_flops``
(a frozen copy of the program's ``utils/profiling.py`` rule) counts it once.
FFTs, elementwise work and MAS are not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: the forward's for each
    gradient asked for (input, weight), grouped or not."""
    forward = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def count(fn) -> int:
    """Runs ``fn()`` and returns the FLOPs of the matmuls and convolutions it
    dispatched."""
    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn()
    return int(counter.get_total_flops())
