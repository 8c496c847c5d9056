"""The compression eval's host side: the H.265 bridge, its stand-in codec and
the streaming pipeline around the device's encode and decode."""
