"""Model families covering the reference's example workloads: the MNIST
CNNs, ResNet, skip-gram word2vec, the long-context Transformer and the
embedding-bag recommender tower (the JAX package's ``models``)."""

from horovod_tpu_torch.models import (embedding_bag, mnist, resnet,
                                      transformer, word2vec)

__all__ = ["embedding_bag", "mnist", "resnet", "transformer", "word2vec"]
