"""The port's host C++ code, bound with ctypes: the JPEG codec
(``jpeg_decode.cc`` and ``jpeg_size.cc``), built at first use by
``dcr_tpu_torch/ops/build.py`` with the host C++ compiler."""
