"""Loss layer functions — the port of paddle_tpu/layers/loss.py (the
builders BERT pretraining calls)."""

from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """Per-row cross entropy of the probabilities ``input`` against
    ``label`` (int64 class ids, or a distribution with ``soft_label``)."""
    helper = LayerHelper("cross_entropy", name=name)
    shape = tuple(input.shape[:-1]) + (1,)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1, name=None):
    """Per-row cross entropy of softmax(logits) against ``label`` (int64
    class ids, or a distribution with ``soft_label``); the loss keeps the
    class axis with size 1."""
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    nd = len(logits.shape)
    ax = axis % nd
    loss_shape = tuple(1 if i == ax else s for i, s in enumerate(logits.shape))
    softmax = helper.create_variable_for_type_inference(logits.dtype,
                                                        logits.shape)
    loss = helper.create_variable_for_type_inference(logits.dtype, loss_shape)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss
