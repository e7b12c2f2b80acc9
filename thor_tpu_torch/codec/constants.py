"""Codec constants and integer tables of the decoder and the encoder.

Values mirror the normative tables of the Thor reference C implementation
(cited per table) so that decode is bit-exact.
"""

import numpy as np

# --- Reference window (common/global.h:57-71) ---
MAX_REF_FRAMES = 33
MAX_REORDER_BUFFER = 32
PAD_Y = 96          # luma reference padding (PADDING_Y)
PAD_C = 48

# --- Lambda: lambda_coeff * squared_lambda_QP[qp] (enc/encode_frame.c:37-46)
SQUARED_LAMBDA_QP = [
    0.0382, 0.0485, 0.0615, 0.0781, 0.0990, 0.1257, 0.1595, 0.2023, 0.2567,
    0.3257, 0.4132, 0.5243, 0.6652, 0.8440, 1.0709, 1.3588, 1.7240, 2.1874,
    2.7754, 3.5214, 4.4679, 5.6688, 7.1926, 9.1259, 11.5789, 14.6912,
    18.6402, 23.6505, 30.0076, 38.0735, 48.3075, 61.2922, 77.7672, 98.6706,
    125.1926, 158.8437, 201.5399, 255.7126, 324.4467, 411.6560, 522.3067,
    662.6996, 840.8294, 1066.8393, 1353.5994, 1717.4389, 2179.0763,
    2764.7991, 3507.9607, 4450.8797, 5647.2498, 7165.1970]

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

# --- Block geometry (common/global.h:57-71) ---
MAX_BLOCK_SIZE = 64
MIN_BLOCK_SIZE = 8
MIN_PB_SIZE = 4
MAX_QUANT_SIZE = 16
MAX_QP = 51

# --- Frame types (common/types.h:69-74) ---
I_FRAME, P_FRAME, B_FRAME = 0, 1, 2

# --- Block modes (common/types.h:76-83) ---
MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED, MODE_MERGE = 0, 1, 2, 3, 4

# --- PB partitions (common/types.h:98-103) ---
PART_NONE, PART_HOR, PART_VER, PART_QUAD = 0, 1, 2, 3

# --- Intra modes (common/types.h:137-149) ---
(MODE_DC, MODE_PLANAR, MODE_HOR, MODE_VER, MODE_UPLEFT, MODE_UPRIGHT,
 MODE_UPUPRIGHT, MODE_UPUPLEFT, MODE_UPLEFTLEFT, MODE_DOWNLEFTLEFT) = range(10)
MAX_NUM_INTRA_MODES = 10

# --- Zigzag scan tables (common/common_block.c:38-73) ---
ZIGZAG16 = np.array([
    0, 1, 5, 6,
    2, 4, 7, 12,
    3, 8, 11, 13,
    9, 10, 14, 15], dtype=np.int32)

ZIGZAG64 = np.array([
    0,  1,  5,  6, 14, 15, 27, 28,
    2,  4,  7, 13, 16, 26, 29, 42,
    3,  8, 12, 17, 25, 30, 41, 43,
    9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63], dtype=np.int32)

ZIGZAG256 = np.array([
    0,  1,  5,  6, 14, 15, 27, 28, 44, 45, 65, 66, 90, 91, 119, 120,
    2,  4,  7, 13, 16, 26, 29, 43, 46, 64, 67, 89, 92, 118, 121, 150,
    3,  8, 12, 17, 25, 30, 42, 47, 63, 68, 88, 93, 117, 122, 149, 151,
    9, 11, 18, 24, 31, 41, 48, 62, 69, 87, 94, 116, 123, 148, 152, 177,
    10, 19, 23, 32, 40, 49, 61, 70, 86, 95, 115, 124, 147, 153, 176, 178,
    20, 22, 33, 39, 50, 60, 71, 85, 96, 114, 125, 146, 154, 175, 179, 200,
    21, 34, 38, 51, 59, 72, 84, 97, 113, 126, 145, 155, 174, 180, 199, 201,
    35, 37, 52, 58, 73, 83, 98, 112, 127, 144, 156, 173, 181, 198, 202, 219,
    36, 53, 57, 74, 82, 99, 111, 128, 143, 157, 172, 182, 197, 203, 218, 220,
    54, 56, 75, 81, 100, 110, 129, 142, 158, 171, 183, 196, 204, 217, 221, 234,
    55, 76, 80, 101, 109, 130, 141, 159, 170, 184, 195, 205, 216, 222, 233, 235,
    77, 79, 102, 108, 131, 140, 160, 169, 185, 194, 206, 215, 223, 232, 236, 245,
    78, 103, 107, 132, 139, 161, 168, 186, 193, 207, 214, 224, 231, 237, 244, 246,
    104, 106, 133, 138, 162, 167, 187, 192, 208, 213, 225, 230, 238, 243, 247, 252,
    105, 134, 137, 163, 166, 188, 191, 209, 212, 226, 229, 239, 242, 248, 251, 253,
    135, 136, 164, 165, 189, 190, 210, 211, 227, 228, 240, 241, 249, 250, 254, 255,
], dtype=np.int32)


def zigzag_for(qsize: int) -> np.ndarray:
    return {4: ZIGZAG16, 8: ZIGZAG64, 16: ZIGZAG256}[qsize]


# --- Quantizer scale table (common/common_block.c:97) ---
GQUANT_TABLE = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)

# --- cbp = y + 2u + 4v -> code number (enc/write_bits.c:293) ---
CBP_TABLE = (1, 0, 5, 2, 6, 3, 7, 4)


def log2i(n: int) -> int:
    """common/simd.h:83-86"""
    return n.bit_length() - 1
