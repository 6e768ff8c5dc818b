"""Memoizer for table and function factories (counterpart of
``taichi_image_tpu/utils/cache.py``): the port builds its weight tables,
resize taps and sample indices once per configuration with it."""

from functools import lru_cache

cache = lru_cache(maxsize=None)
