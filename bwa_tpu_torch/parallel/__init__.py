"""Reads data-parallel over the cards of a host (mesh.py) and over hosts
(multihost.py), and the dry run that holds both to one device (dryrun.py).
"""
