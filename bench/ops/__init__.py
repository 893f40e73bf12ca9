"""The ops a traffic mix can name, one module each (`ops/<op>.py`).

An op module gives the bytes and operations of one whole step as the op
defines it (each input read once, each output written once, whatever
implements it), and the plain reference of one step over a state of
field-stacked tensors (`inputs.GROUPS`).
"""
