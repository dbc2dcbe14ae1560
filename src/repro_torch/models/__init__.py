"""Model definitions: the WS+GN ResNet dual encoder (paper Fig. 1, Sec 4.2)."""
