"""Place-recognition models of the port: CosPlace (ResNet-18) and
NetVLAD (VGG16), loading the JAX package's shipped weights."""
