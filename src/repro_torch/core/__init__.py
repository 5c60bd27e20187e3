"""Flex-PE core: FxP quantization, SIMD packing, CORDIC, configurable
activation functions, precision policy and quantize-once weights."""
