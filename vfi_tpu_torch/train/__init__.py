"""Training of the port: losses (``losses``), the GAN and SCT training
environments (``environments``) and Super SloMo's (``slomo_env``)."""
