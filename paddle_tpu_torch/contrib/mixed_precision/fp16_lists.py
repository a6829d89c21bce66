"""Mixed-precision op lists (ref: contrib/mixed_precision/fp16_lists.py) —
the JAX package's lists, verbatim.

white = compute in bf16/fp16 (the matrix products: matmuls/convs/attention);
black = keep fp32 (reductions/losses/normalisation statistics);
gray  = follow their inputs."""

from __future__ import annotations

WHITE_LIST = {
    "mul", "matmul", "matmul_v2", "conv2d", "depthwise_conv2d",
    "conv2d_transpose", "fused_attention",
}

BLACK_LIST = {
    "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "mean", "reduce_mean", "reduce_sum", "sum", "exp", "log",
    "sigmoid_cross_entropy_with_logits", "square_error_cost",
    "softmax", "log_softmax",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "kldiv_loss", "huber_loss", "smooth_l1_loss",
    "squared_l2_norm", "p_norm", "clip_by_norm",
    "lr_schedule", "accuracy", "top_k", "arg_max",
}

GRAY_LIST = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min", "relu",
    "gelu", "tanh", "sigmoid", "leaky_relu", "relu6", "swish",
    "dropout", "reshape2", "reshape", "transpose2", "transpose", "concat",
    "split", "stack", "slice", "squeeze2", "unsqueeze2", "scale", "pool2d",
    "gather", "gather_tokens", "pad", "expand", "expand_v2", "tile",
    "flatten2", "flatten_contiguous_range", "clip", "label_smooth",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        self.gray_list = set(GRAY_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
        self.black_varnames = set(custom_black_varnames or ())
