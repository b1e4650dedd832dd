"""Model modules of the port: anchors, layers, network, detector and the
weight bridge from the JAX package's variables."""
