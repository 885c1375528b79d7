"""Frozen copies of the port's file loaders that the plain reference uses.

Each file is a copy of the port's module of the same name
(``linearham_tpu_torch/{utils/constants,io/germline,io/partis}.py``) with
its imports made relative.  They parse the partis output YAML and the
partis HMM germline directory into plain numbers, and the generator
writes germline directories through the same file.  Nothing else of the
program is copied: the reference lays out its states and steps from
those numbers itself (``reference/model.py``).
"""
