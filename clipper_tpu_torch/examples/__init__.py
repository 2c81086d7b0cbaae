"""The reference's examples on the port, each a module with ``main(argv)``:

    python -m clipper_tpu_torch.examples.ex1_known_scale_registration
    python -m clipper_tpu_torch.examples.ex3_plane_cloud
    python -m clipper_tpu_torch.examples.ex4_bunny
    python -m clipper_tpu_torch.examples.ex5_large_scale [m]

Each runs on ``--device=cuda`` (the default; raises without CUDA) or
``--device=cpu``, asserts its own results and prints the marker lines of
its JAX twin under ``examples/``.
"""
