"""Breakdown field-attribute grammar: `name[attr=val,attr2],name2`.

Re-implements the grammar of the reference's lib/attr-parser.js:17-77,
including its exact error messages ("missing field name", "missing attribute
name", "unexpected end of string") and its quirks:

* empty list items are skipped (`a,,b` == `a,b`),
* a trailing single character after `]` is dropped (the reference's
  `j < str.length - 1` off-by-one; behavior parity requires keeping it),
* attributes without `=` get the empty-string value.

Errors are returned, not raised (matching the reference's contract).
"""

from .errors import DNError


def attrs_parse(s):
    propname = None
    props = None
    rv = []
    i = 0
    j = 0
    n = len(s)
    for i in range(n):
        ch = s[i]
        if propname is None:
            if ch == ',':
                if i - j > 0:
                    rv.append({'name': s[j:i]})
                j = i + 1
            elif ch == '[':
                if i - j == 0:
                    return DNError('missing field name')
                propname = s[j:i]
                props = {'name': propname}
                j = i + 1
            continue

        if ch == ',' or ch == ']':
            if i - j > 0:
                propdef = s[j:i]
                eq = propdef.find('=')
                if eq == -1:
                    props[propdef] = ''
                elif eq == 0:
                    return DNError('missing attribute name')
                else:
                    props[propdef[:eq]] = propdef[eq + 1:]

            if ch == ']':
                rv.append(props)
                propname = None
                props = None

            j = i + 1

    if propname is not None:
        return DNError('unexpected end of string')

    # Reference quirk: `j < str.length - 1` (not `<=`), so a lone trailing
    # character after a ']' is silently dropped.
    if j < n - 1:
        rv.append({'name': s[j:]})

    return rv
