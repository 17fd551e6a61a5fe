"""SOAP descriptor: harmonics, radial functions, power spectrum and the
coefficient kernels."""
