"""thor_tpu_torch: the Thor video decoder and the device encoder's
I-frame path in PyTorch, with hand-written CUDA kernels for Hopper
(sm_90a).

A port of thor_tpu (JAX on TPU), which stays beside it as the reference.
This package imports torch and numpy, never jax and nothing of thor_tpu.
Entry points run on the card unless the caller passes device="cpu"; each
kernel wrapper takes its plain PyTorch version only for a CPU tensor.

    from thor_tpu_torch.dec.decoder import decode_file
    frames = decode_file("stream.bit")            # on cuda

    from thor_tpu_torch.enc.encoder import Encoder, EncoderParams
    enc = Encoder(EncoderParams(width=w, height=h, intra_period=1,
                                device_encode=1))
    recons = enc.encode_sequence(frames, "out.bit")
"""
