"""Integrity: the CRC32C behind ``Session.state_digest``."""
