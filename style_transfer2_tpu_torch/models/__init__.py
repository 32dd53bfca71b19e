"""The truncated VGG-19 and its weights."""

from .vgg19 import (BLOB_NAMES, CONV_SPECS, MEAN_RGB, VGG19Features,
                    blob_index, deprocess, extract_features, layer_channels,
                    preprocess)
from .weights import (load_params, params_from_caffemodel,
                      params_from_numpy, params_from_torchvision,
                      random_params, resolve_params, save_params,
                      write_caffemodel)

__all__ = ['BLOB_NAMES', 'CONV_SPECS', 'MEAN_RGB', 'VGG19Features',
           'blob_index', 'deprocess', 'extract_features', 'layer_channels',
           'preprocess', 'load_params', 'params_from_caffemodel',
           'params_from_numpy', 'params_from_torchvision', 'random_params',
           'resolve_params', 'save_params', 'write_caffemodel']
