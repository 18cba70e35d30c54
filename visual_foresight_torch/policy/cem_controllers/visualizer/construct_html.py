"""Planner HTML visualization (reference ``visualizer/construct_html.py``).

Builds a per-CEM-iteration HTML table (start image, top-k predicted rollout
gifs, pixel-distribution heatmaps, scores); all file IO goes through the async
file worker so the control loop never blocks.  Everything put on the
worker's queue is numpy: the worker is forked from a process that may hold
a CUDA context, and must not touch it.
"""

import numpy as np


class HTMLTemplate:
    HEAD = ('<!DOCTYPE html>\n<html>\n<head><style>'
            'table{border-collapse:collapse}'
            'td,th{border:1px solid #999;padding:4px;text-align:center}'
            'img{image-rendering:pixelated}'
            '</style></head>\n<body>\n')
    TAIL = '</body>\n</html>\n'


def fill_template(cem_itr, t, content_dict, img_height=128):
    """Render an OrderedDict of row-name -> list-of-cell-contents into an HTML
    table. Cells that look like file paths become <img>; numbers print."""
    html = [HTMLTemplate.HEAD]
    html.append('<h3>planning step t={} CEM iteration {}</h3>\n'.format(t, cem_itr))
    html.append('<table>\n')
    for name, row in content_dict.items():
        html.append('<tr><th>{}</th>'.format(name))
        values = row if isinstance(row, (list, tuple, np.ndarray)) else [row]
        for v in values:
            if isinstance(v, str):
                html.append('<td><img src="{}" height="{}"></td>'.format(
                    v, img_height))
            elif isinstance(v, (float, np.floating)):
                html.append('<td>{:.4f}</td>'.format(v))
            else:
                html.append('<td>{}</td>'.format(v))
        html.append('</tr>\n')
    html.append('</table>\n')
    html.append(HTMLTemplate.TAIL)
    return ''.join(html)


def save_gifs(save_worker, folder, name, image_lists, fps=4):
    """Queue one gif per list of frames; returns the relative paths used in
    the HTML."""
    paths = []
    for i, frames in enumerate(image_lists):
        rel = '{}/{}_{}.gif'.format(folder, name, i)
        save_worker.put(('mov', rel, [np.asarray(f) for f in frames], fps))
        paths.append('{}_{}.gif'.format(name, i))
    return paths


def save_img(save_worker, folder, name, image):
    rel = '{}/{}.png'.format(folder, name)
    save_worker.put(('img', rel, np.asarray(image)))
    return '{}.png'.format(name)


def save_html(save_worker, path, html):
    save_worker.put(('txt_file', path, html))
