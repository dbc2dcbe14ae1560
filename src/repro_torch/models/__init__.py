"""Model definitions: the WS+GN ResNet dual encoder (paper Fig. 1, Sec 4.2)
and the dense GQA transformer towers of the token dual encoder."""
