"""Keras-2-style layer spellings — the reference's whole keras2 surface.

Counterpart of ``analytics_zoo_tpu/keras2/layers.py``. The reference's
keras2 package (ref ``pyzoo/zoo/pipeline/api/keras2/``) defines exactly
17 classes + 3 functional helpers across five modules — core.py (Dense,
Activation, Dropout, Flatten), convolutional.py (Conv1D, Conv2D,
Cropping1D), pooling.py (MaxPooling1D, AveragePooling1D,
GlobalAveragePooling1D, GlobalMaxPooling1D, GlobalAveragePooling2D),
merge.py (Maximum/maximum, Minimum/minimum, Average/average) and local.py
(LocallyConnected1D). Its other modules are license-header-only stubs.

Every class here adapts the Keras-2 argument names (``units``,
``filters``, ``kernel_size``, ``strides``, ``padding``, ``rate``,
``pool_size``, ``kernel_regularizer``/``bias_regularizer``,
``input_dim``) onto the corresponding ``analytics_zoo_tpu_torch.keras.layers``
class, so keras-2-flavored code runs on the same ``GraphModule``;
regularizers feed the train step's penalty (``keras/regularizers.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from analytics_zoo_tpu_torch.keras import layers as k1

Activation = k1.Activation
Dropout = k1.Dropout  # keras2 'rate' is positional like keras1 'p'
Flatten = k1.Flatten
# same signatures in both API generations (ref keras2/convolutional.py:196
# Cropping1D, keras2/pooling.py Global*Pooling)
GlobalAveragePooling1D = k1.GlobalAveragePooling1D
GlobalAveragePooling2D = k1.GlobalAveragePooling2D
GlobalMaxPooling1D = k1.GlobalMaxPooling1D
Cropping1D = k1.Cropping1D


def _single(v):
    return v[0] if isinstance(v, (tuple, list)) else v


class Dense(k1.Dense):
    """keras2: Dense(units, activation=..., use_bias=...)
    (ref keras2/layers/core.py:26 — incl. kernel/bias regularizers and the
    ``input_dim`` shorthand for a 2D first layer)."""

    def __init__(self, units: int, activation=None,
                 kernel_initializer="glorot_uniform", use_bias: bool = True,
                 kernel_regularizer=None, bias_regularizer=None,
                 input_dim=None, input_shape=None, name=None, **kw):
        if input_dim:
            input_shape = (input_dim,)
        super().__init__(units, activation=activation,
                         init=kernel_initializer, bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class Conv1D(k1.Conv1D):
    """keras2: Conv1D(filters, kernel_size, strides=1, padding='valid')
    (ref keras2/layers/convolutional.py:24)."""

    def __init__(self, filters: int, kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "valid", activation=None,
                 dilation_rate: Union[int, Sequence[int]] = 1,
                 use_bias: bool = True,
                 kernel_regularizer=None, bias_regularizer=None,
                 kernel_initializer="glorot_uniform", input_shape=None,
                 name=None, **kw):
        super().__init__(filters, _single(kernel_size),
                         activation=activation, border_mode=padding,
                         subsample_length=_single(strides),
                         init=kernel_initializer, bias=use_bias,
                         dilation_rate=_single(dilation_rate),
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class Conv2D(k1.Conv2D):
    """keras2: Conv2D(filters, kernel_size, ...)
    (ref keras2/layers/convolutional.py:100)."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding: str = "valid", activation=None,
                 use_bias: bool = True,
                 kernel_regularizer=None, bias_regularizer=None,
                 kernel_initializer="glorot_uniform", input_shape=None,
                 name=None, **kw):
        ks = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else tuple(kernel_size))
        super().__init__(filters, ks[0], ks[1], activation=activation,
                         border_mode=padding, subsample=strides,
                         init=kernel_initializer, bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class MaxPooling1D(k1.MaxPooling1D):
    """keras2: MaxPooling1D(pool_size, strides=None, padding='valid')."""

    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", input_shape=None, name=None, **kw):
        super().__init__(pool_length=_single(pool_size),
                         stride=_single(strides) if strides else None,
                         border_mode=padding, input_shape=input_shape,
                         name=name)


class AveragePooling1D(k1.AveragePooling1D):
    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid", input_shape=None, name=None, **kw):
        super().__init__(pool_length=_single(pool_size),
                         stride=_single(strides) if strides else None,
                         border_mode=padding, input_shape=input_shape,
                         name=name)


class LocallyConnected1D(k1.LocallyConnected1D):
    """keras2: LocallyConnected1D(filters, kernel_size, strides=1)
    (ref keras2/layers/local.py:23 — padding='valid' only, as there)."""

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 kernel_regularizer=None, bias_regularizer=None,
                 use_bias: bool = True, input_shape=None,
                 name=None, **kw):
        if padding != "valid":
            raise ValueError("For LocallyConnected1D, only padding='valid' "
                             "is supported for now")
        super().__init__(filters, _single(kernel_size),
                         activation=activation,
                         subsample_length=_single(strides), bias=use_bias,
                         W_regularizer=kernel_regularizer,
                         b_regularizer=bias_regularizer,
                         input_shape=input_shape, name=name)


class _MergeN(k1.Merge):
    mode = "ave"

    def __init__(self, input_shape=None, name=None, **kw):
        super().__init__(mode=self.mode, input_shape=input_shape, name=name)


class Average(_MergeN):
    """Element-wise mean over inputs (ref keras2/merge.py Average)."""
    mode = "ave"


class Maximum(_MergeN):
    mode = "max"


class Minimum(_MergeN):
    mode = "min"


# functional merge interfaces (ref keras2/layers/merge.py:44,82,121)
def maximum(inputs, **kwargs):
    """Element-wise maximum of a list of input nodes."""
    return Maximum(**kwargs)(inputs)


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(inputs)


def average(inputs, **kwargs):
    return Average(**kwargs)(inputs)
