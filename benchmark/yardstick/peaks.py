"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
full 700 W power limit): an fp32 product on the tensor cores is three TF32
products (the 3xTF32 split that keeps fp32 accuracy), so its rate is TF32's
over 3."""

PEAK_TF32 = 495e12              # FLOP/s, TF32 on the tensor cores
PEAK_FP32_TC = PEAK_TF32 / 3    # FLOP/s, an fp32-accurate product (3xTF32): 165 TFLOP/s
PEAK_FP32_FMA = 67e12           # FLOP/s, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3
