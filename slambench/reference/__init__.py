"""The plain reference that decides `correct`: numpy and torch only, and
nothing of `jax`, `veloslam_tpu` or `veloslam_tpu_torch`.

It reads the drive's files as the program read them, works out the
frame schedule again from the packets (`frames`), takes the vehicle's
true path from the drive's recipe (`truth`), and judges each answer of
the program against those (`check`).
"""
