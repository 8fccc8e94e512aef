"""Training of the port: losses (``losses``) and the GAN training environments
(``environments``)."""
