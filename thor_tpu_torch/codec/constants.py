"""Codec constants and integer tables the decoder uses.

Values mirror the normative tables of the Thor reference C implementation
(cited per table) so that decode is bit-exact.
"""

import numpy as np

# --- Reference window (common/global.h:57-71) ---
MAX_REF_FRAMES = 33
MAX_REORDER_BUFFER = 32
PAD_Y = 96          # luma reference padding (PADDING_Y)
PAD_C = 48

# --- Chroma QP map (common/common_block.c:78-83) ---
CHROMA_QP = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29,
    30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38,
    39, 40, 41, 42, 43, 44, 45], dtype=np.int32)

# --- Dequantizer scale table (common/common_block.c:97-98) ---
GDEQUANT_TABLE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

# --- Deblocking thresholds (common/common_frame.c:36-44) ---
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
    40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)

TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 9,
    10, 10, 11, 11, 12, 12, 13, 13, 14, 14], dtype=np.int32)

# --- Inter prediction filters (common/inter_prediction.c:47-70) ---
FILTER_Y_BI = np.array([
    [0, 0, 64, 0, 0, 0],
    [2, -10, 59, 17, -5, 1],
    [1, -8, 39, 39, -8, 1],
    [1, -5, 17, 59, -10, 2]], dtype=np.int32)

FILTER_Y_UNI = np.array([
    [0, 0, 64, 0, 0, 0],
    [1, -7, 55, 19, -5, 1],
    [1, -7, 38, 38, -7, 1],
    [1, -5, 19, 55, -7, 1]], dtype=np.int32)

FILTER_C = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-4, 44, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 44, -4],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], dtype=np.int32)

# 4x4 low-pass used at the luma (1/2,1/2) "funny position"
# (common/inter_prediction.c:145-157)
FILTER_Y_CENTER = np.array([
    [0, 1, 1, 0],
    [1, 2, 2, 1],
    [1, 2, 2, 1],
    [0, 1, 1, 0]], dtype=np.int32)
