"""The reference's examples on the port, one module each, run as

    python -m horovod_tpu_torch.examples.<name> [flags] [--device cpu]

``mnist``, ``keras_mnist``, ``keras_mnist_advanced``, ``mnist_estimator``,
``imagenet_resnet50``, ``grouped_collectives``, ``lm_generate``,
``word2vec`` and ``embedding_bag`` take the
flags and defaults of the JAX package's ``examples/<name>.py``, plus
``--device`` (``cuda``, the default, or ``cpu``; without CUDA the default
raises instead of running on the CPU). Each module's ``main(argv)`` parses
``argv`` (default: the command line) and returns what it measured, so a
caller in the same process can check it. Every rank is a process: launch a
world with ``torchrun`` or ``horovod_tpu_torch.run.run(main, np,
args=(argv,))``.
"""
